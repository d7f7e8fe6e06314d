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
inputs stay in full f32 on the CUDA cores, a thread holding 4 pixels x 9 dx
of one dy, neighbouring lanes splitting the channels (more lanes, smaller
tiles at the coarse levels), operands staged by `cp.async` too. Both stage
the output tile in shared memory and write it in full lines.

Semantics (PWC-Net convention): for d=(dy,dx) in [-r,r]^2,
out[n,y,x,k(d)] = mean_c f1[n,y,x,c] * f2[n,y+dy,x+dx,c], f2 zero outside
its bounds, k = (dy+r)*(2r+1)+(dx+r). Products and sum in f32; the output
has f1's dtype.

Gradient: the CUDA path always goes through `CostVolumeFn` (without a graph,
as under `no_grad` or `inference_mode`, that is the forward launch and nothing
else), whose backward is `cost_volume_backward`: it launches
`vstab_cost_volume_bwd` of the same source (two gathers over the window, no
atomics; no TPU counterpart, the JAX trainer differentiates the XLA
formulation). For C % 4 == 0 on aligned tensors that is the tiled
`cost_volume_bwd_kernel`: a block stages g for its tile and the other
feature map's halo band in shared memory, a thread sums 4 pixels x 4
channels over the window, the window's rows split over warps at the coarse
levels; the tile follows from the image size alone, so an image's gradient
does not depend on the batch. `cost_volume_backward_plain`
writes the same gradients out with shifts; on the CPU autograd of the plain
forward is what runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

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
KERNEL_BWD = CudaKernel(
    "cost_volume",
    "vstab_cost_volume_bwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
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


def cost_volume_backward_plain(
    g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, radius: int = 4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(df1, df2) of `cost_volume_plain` for g = dL/dout [N,H,W,(2r+1)^2],
    written out with shifts: df1 gathers f2 at +d weighted by g, df2 adds
    g * f1 into the pixel at +d (in a zero halo that is cut off again)."""
    n, h, w, c = f1.shape
    r = radius
    gf, a = g.float(), f1.float()
    f2p = F.pad(f2.float(), (0, 0, r, r, r, r))
    df1 = torch.zeros_like(a)
    df2p = torch.zeros_like(f2p)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            gk = gf[..., dy * (2 * r + 1) + dx, None]
            df1 += gk * f2p[:, dy : dy + h, dx : dx + w]
            df2p[:, dy : dy + h, dx : dx + w] += gk * a
    df2 = df2p[:, r : r + h, r : r + w]
    return (df1 / c).to(f1.dtype), (df2 / c).to(f2.dtype)


def cost_volume_backward(
    g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, radius: int = 4,
    need: Tuple[bool, bool] = (True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(df1, df2) of `cost_volume` for g = dL/dout, None where `need` is
    False: the backward CUDA kernel for CUDA tensors (one launch for both),
    the plain version for CPU tensors; anything else raises."""
    if f1.is_cuda:
        check_cuda("cost_volume_backward", {"f1": f1, "f2": f2}, (torch.float32, torch.bfloat16))
        check_cuda("cost_volume_backward", {"g": g, "f1": f1}, (f1.dtype,))
        n, h, w, c = f1.shape
        if f2.shape != f1.shape or f2.dtype != f1.dtype or tuple(g.shape) != (n, h, w, (2 * radius + 1) ** 2):
            raise ValueError(
                f"cost_volume_backward: g {tuple(g.shape)}, f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)} "
                f"do not belong to one cost volume of radius {radius}"
            )
        if not 1 <= radius <= MAX_RADIUS:
            raise ValueError(f"cost_volume_backward: radius {radius} not in 1..{MAX_RADIUS}")
        df1 = torch.empty_like(f1) if need[0] else None
        df2 = torch.empty_like(f2) if need[1] else None
        if f1.numel() and (need[0] or need[1]):
            KERNEL_BWD(
                g.data_ptr(), f1.data_ptr(), f2.data_ptr(),
                None if df1 is None else df1.data_ptr(),
                None if df2 is None else df2.data_ptr(),
                n, h, w, c, radius, DTYPE_CODES[f1.dtype], stream_ptr(f1),
            )
        return df1, df2
    if f1.device.type == "cpu":
        df1, df2 = cost_volume_backward_plain(g, f1, f2, radius)
        return (df1 if need[0] else None), (df2 if need[1] else None)
    raise ValueError(f"cost_volume_backward: no kernel for device {f1.device}")


class CostVolumeFn(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (CUDA
    tensors only; `cost_volume` has checked them)."""

    @staticmethod
    def forward(ctx, f1, f2, radius):
        ctx.radius = radius
        ctx.save_for_backward(f1, f2)
        n, h, w, c = f1.shape
        out = torch.empty((n, h, w, (2 * radius + 1) ** 2), dtype=f1.dtype, device=f1.device)
        if out.numel():
            KERNEL(
                f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, h, w, c,
                radius, DTYPE_CODES[f1.dtype], stream_ptr(f1),
            )
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        # autograd may hand over a strided view: made contiguous, not refused
        df1, df2 = cost_volume_backward(g.contiguous(), f1, f2, ctx.radius, ctx.needs_input_grad[:2])
        return df1, df2, None


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """[N,H,W,C] x [N,H,W,C] -> [N,H,W,(2r+1)^2]: the CUDA kernel for CUDA
    tensors (f32 or bf16, contiguous, radius <= 4; differentiable through
    `CostVolumeFn`), the plain version for CPU tensors; anything else raises."""
    if f1.is_cuda:
        check_cuda("cost_volume", {"f1": f1, "f2": f2}, (torch.float32, torch.bfloat16))
        if f1.dtype != f2.dtype or f1.shape != f2.shape or f1.dim() != 4:
            raise ValueError(
                f"cost_volume: f1 {tuple(f1.shape)} {f1.dtype} and f2 "
                f"{tuple(f2.shape)} {f2.dtype} must be equal [N,H,W,C]"
            )
        if not 1 <= radius <= MAX_RADIUS:
            raise ValueError(f"cost_volume: radius {radius} not in 1..{MAX_RADIUS}")
        return CostVolumeFn.apply(f1, f2, radius)
    if f1.device.type == "cpu":
        return cost_volume_plain(f1, f2, radius)
    raise ValueError(f"cost_volume: no kernel for device {f1.device}")


__all__ = [
    "KERNEL",
    "KERNEL_BWD",
    "CostVolumeFn",
    "cost_volume",
    "cost_volume_backward",
    "cost_volume_backward_plain",
    "cost_volume_plain",
]
