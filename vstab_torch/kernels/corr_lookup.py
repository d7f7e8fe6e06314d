"""RAFT's correlation-pyramid lookup.

`corr_lookup` launches the CUDA kernel of `csrc/corr_lookup.cu` for CUDA
tensors and runs `corr_lookup_plain` for CPU tensors.

Replaces no TPU kernel (the JAX package has no RAFT): RAFT's `CorrBlock`
samples every level with `grid_sample` and concatenates the levels; here one
launch reads all of them and writes the channels-last row that the motion
encoder's first convolution takes, in its dtype. Bound on the H100: bytes,
each pixel's (2r+2)^2 window of each level read once and its row written
once (see the source's header for the design). No backward: inference only.

Semantics (RAFT, arXiv 2003.12039, `core/corr.py`): level l of pixel p is
`pyramid[l][p]`, a [H_l, W_l] image; it is sampled at (x, y) =
coords[p] / 2^l + (a - r, b - r) for a, b in 0..2r, x offset from a (the
slow index) and y from b (RAFT's meshgrid(dy, dx) order); channel
l (2r+1)^2 + a (2r+1) + b. Bilinear at pixel coordinates, each tap outside
the level reading 0.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from vstab_torch.kernels._build import DTYPE_CODES, CudaKernel, check_cuda, stream_ptr

KERNEL = CudaKernel(
    "corr_lookup",
    "vstab_corr_lookup",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
)
MAX_LEVELS = 4
MAX_RADIUS = 4


def corr_lookup_plain(
    pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """`grid_sample` per level, as RAFT's `CorrBlock.__call__`: pyramid
    [P, H_l, W_l] float32 each, coords [N,H,W,2] (x, y) with P = N H W ->
    [N,H,W,levels (2r+1)^2] in out_dtype. Each level is padded by one zero
    pixel a side first: RAFT normalises by W_l - 1, which is 0 on a level one
    pixel wide, and the padding leaves every other sample as it was."""
    n, h, w, _ = coords.shape
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    outs = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        c = coords.reshape(-1, 1, 1, 2).float() / 2**lvl
        x, y = torch.broadcast_tensors(  # [P, a, b]: x from a, y from b; + the pad
            c[..., 0] + d.view(1, k, 1) + 1.0, c[..., 1] + d.view(1, 1, k) + 1.0
        )
        grid = torch.stack([2.0 * x / (wl + 1) - 1.0, 2.0 * y / (hl + 1) - 1.0], dim=-1)
        padded = F.pad(corr.float()[:, None], (1, 1, 1, 1))
        outs.append(F.grid_sample(padded, grid, align_corners=True).reshape(n, h, w, k * k))
    return torch.cat(outs, dim=-1).to(out_dtype)


def corr_lookup(
    pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """[N,H,W,levels (2r+1)^2] samples of the pyramid around coords: the
    CUDA kernel for CUDA tensors (float32 levels [N H W, H_l, W_l] and coords
    [N,H,W,2], contiguous; 1 to 4 levels, radius 1 to 4; out float32 or
    bfloat16), the plain version for CPU tensors; anything else raises."""
    if coords.is_cuda:
        levels = len(pyramid)
        tensors = {f"level{i}": t for i, t in enumerate(pyramid)}
        check_cuda("corr_lookup", {**tensors, "coords": coords}, (torch.float32,))
        if out_dtype not in DTYPE_CODES:
            raise TypeError(f"corr_lookup: out_dtype {out_dtype} is not one of {list(DTYPE_CODES)}")
        if not 1 <= levels <= MAX_LEVELS or not 1 <= radius <= MAX_RADIUS:
            raise ValueError(
                f"corr_lookup: {levels} levels, radius {radius}; the kernel takes 1..{MAX_LEVELS} "
                f"levels and radius 1..{MAX_RADIUS}"
            )
        n, h, w, two = coords.shape
        npix = n * h * w
        if two != 2 or any(t.dim() != 3 or t.shape[0] != npix for t in pyramid):
            raise ValueError(
                f"corr_lookup: coords {tuple(coords.shape)} need levels [{npix}, H_l, W_l], got "
                f"{[tuple(t.shape) for t in pyramid]}"
            )
        out = torch.empty((n, h, w, levels * (2 * radius + 1) ** 2), dtype=out_dtype,
                          device=coords.device)
        ptrs = [t.data_ptr() for t in pyramid] + [None] * (MAX_LEVELS - levels)
        sizes = [s for t in pyramid for s in t.shape[1:]] + [0, 0] * (MAX_LEVELS - levels)
        if npix:
            KERNEL(*ptrs, *sizes, levels, radius, coords.data_ptr(), out.data_ptr(), npix,
                   DTYPE_CODES[out_dtype], stream_ptr(coords))
        return out
    if coords.device.type == "cpu":
        return corr_lookup_plain(pyramid, coords, radius, out_dtype)
    raise ValueError(f"corr_lookup: no kernel for device {coords.device}")


__all__ = ["KERNEL", "corr_lookup", "corr_lookup_plain"]
