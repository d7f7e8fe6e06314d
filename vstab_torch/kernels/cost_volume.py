"""Cost volume (PWC-Net windowed correlation).

`cost_volume` launches the CUDA kernel of `csrc/cost_volume.cu` for CUDA
tensors and runs `cost_volume_plain` for CPU tensors.

Replaces `vstab/kernels/cost_volume.py:cost_volume_pallas`. Bound on the
H100: bytes at the finest estimated level of a 720p clip (8 pairs of
192x320x32 bf16: 62.9 MB read, 79.6 MB written), and from 64 channels up the
2*81*C operations per pixel unless they run on the tensor cores. Design (see
the source's header): bf16 inputs go through `mma.sync` on the tensor cores,
a warp per (row, 8 pixels) holding the band of the product f2-row x f1-row
in registers, operands staged as bf16 in shared memory by `cp.async`; f32
inputs stay in full f32 on the CUDA cores, one thread per pixel. Both stage
the output tile in shared memory and write it in full lines.

Semantics (PWC-Net convention): for d=(dy,dx) in [-r,r]^2,
out[n,y,x,k(d)] = mean_c f1[n,y,x,c] * f2[n,y+dy,x+dx,c], f2 zero outside
its bounds, k = (dy+r)*(2r+1)+(dx+r). Products and sum in f32; the output
has f1's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vstab_torch.kernels._build import (
    DTYPE_CODES,
    CudaKernel,
    check_cuda,
    stream_ptr,
)

KERNEL = CudaKernel(
    "cost_volume",
    "vstab_cost_volume",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
MAX_RADIUS = 4


def cost_volume_plain(f1: torch.Tensor, f2: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Shift-and-multiply formulation of `cost_volume_xla`, in torch ops:
    [N,H,W,C] x [N,H,W,C] -> [N,H,W,(2r+1)^2]."""
    n, h, w, c = f1.shape
    r = radius
    a = f1.float()
    f2p = F.pad(f2.float(), (0, 0, r, r, r, r))
    outs = []
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            outs.append((a * f2p[:, dy : dy + h, dx : dx + w]).mean(dim=-1))
    return torch.stack(outs, dim=-1).to(f1.dtype)


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """[N,H,W,C] x [N,H,W,C] -> [N,H,W,(2r+1)^2]: the CUDA kernel for CUDA
    tensors (f32 or bf16, contiguous, radius <= 4), the plain version for
    CPU tensors; anything else raises."""
    if f1.is_cuda:
        check_cuda("cost_volume", {"f1": f1, "f2": f2}, (torch.float32, torch.bfloat16))
        if f1.dtype != f2.dtype or f1.shape != f2.shape or f1.dim() != 4:
            raise ValueError(
                f"cost_volume: f1 {tuple(f1.shape)} {f1.dtype} and f2 "
                f"{tuple(f2.shape)} {f2.dtype} must be equal [N,H,W,C]"
            )
        if not 1 <= radius <= MAX_RADIUS:
            raise ValueError(f"cost_volume: radius {radius} not in 1..{MAX_RADIUS}")
        n, h, w, c = f1.shape
        out = torch.empty((n, h, w, (2 * radius + 1) ** 2), dtype=f1.dtype, device=f1.device)
        if out.numel():
            KERNEL(
                f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, h, w, c,
                radius, DTYPE_CODES[f1.dtype], stream_ptr(f1),
            )
        return out
    if f1.device.type == "cpu":
        return cost_volume_plain(f1, f2, radius)
    raise ValueError(f"cost_volume: no kernel for device {f1.device}")


__all__ = ["KERNEL", "cost_volume", "cost_volume_plain"]
