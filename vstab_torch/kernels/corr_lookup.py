"""RAFT's correlation-pyramid lookup.

`corr_lookup` launches the CUDA kernel of `csrc/corr_lookup.cu` for CUDA
tensors and runs `corr_lookup_plain` for CPU tensors.

Replaces no TPU kernel (the JAX package has no RAFT): RAFT's `CorrBlock`
samples every level with `grid_sample` and concatenates the levels; here one
launch reads all of them and writes the channels-last row that the motion
encoder's first convolution takes, in its dtype. Bound on the H100: bytes,
each pixel's (2r+2)^2 window of each level read once and its row written
once (see the source's header for the design).

Gradient (training): where autograd records a graph, the CUDA path goes
through `CorrLookupFn`, whose forward is the same launch and whose backward
launches `vstab_corr_lookup_bwd` of the same source: d pyramid from float32
d out, each pixel's slice of every level written whole (its window's
gradient, zeros elsewhere). The coordinates get no gradient (RAFT detaches
them; the Function raises if they ask for one). `corr_lookup_backward_plain`
writes the same gradient out in torch ops; on the CPU autograd of
`corr_lookup_plain` (`grid_sample`) is what runs, and is the oracle of both.

Semantics (RAFT, arXiv 2003.12039, `core/corr.py`): level l of pixel p is
`pyramid[l][p]`, a [H_l, W_l] image; it is sampled at (x, y) =
coords[p] / 2^l + (a - r, b - r) for a, b in 0..2r, x offset from a (the
slow index) and y from b (RAFT's meshgrid(dy, dx) order); channel
l (2r+1)^2 + a (2r+1) + b. Bilinear at pixel coordinates, each tap outside
the level reading 0.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vstab_torch.kernels._build import DTYPE_CODES, CudaKernel, check_cuda, stream_ptr
from vstab_torch.utils import trace

KERNEL = CudaKernel(
    "corr_lookup",
    "vstab_corr_lookup",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
)
KERNEL_BWD = CudaKernel(
    "corr_lookup",
    "vstab_corr_lookup_bwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
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


def lookup_bwd_bytes(npix: int, levels: int, radius: int) -> int:
    """The least bytes of one backward launch: per pixel its float32
    gradient row read, its coordinates read, and each level's (2r+2)^2
    window written (the rest of its slices is zeros, which the count leaves
    out)."""
    k, side = 2 * radius + 1, 2 * radius + 2
    return npix * (levels * k * k * 4 + 8 + levels * side * side * 4)


def corr_lookup_backward_plain(
    g: torch.Tensor, sizes: Sequence[Tuple[int, int]], coords: torch.Tensor, radius: int = 4,
) -> List[torch.Tensor]:
    """d pyramid [P, H_l, W_l] float32 a level of the lookup for g = d out
    [N,H,W,levels (2r+1)^2], the coordinates held fixed, written out as the
    kernel computes it: the window's gradient at the integer corner (each
    sample's four taps weighted as in the forward), placed where it lies
    inside the level, zeros elsewhere."""
    k, side = 2 * radius + 1, 2 * radius + 2
    p = coords.numel() // 2
    gf = g.float().reshape(p, len(sizes), k, k)  # [P, level, a (x), b (y)]
    c = coords.float().reshape(p, 2)
    out = []
    for lvl, (h, w) in enumerate(sizes):
        x, y = c[:, 0] / 2**lvl, c[:, 1] / 2**lvl
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0).view(p, 1, 1), (y - y0).view(p, 1, 1)
        gt = gf[:, lvl].transpose(1, 2)  # [P, b, a]: rows y, columns x
        win = torch.zeros((p, side, side), dtype=torch.float32, device=g.device)
        win[:, :k, :k] += (1 - fx) * (1 - fy) * gt
        win[:, :k, 1:] += fx * (1 - fy) * gt
        win[:, 1:, :k] += (1 - fx) * fy * gt
        win[:, 1:, 1:] += fx * fy * gt
        offs = torch.arange(side, device=g.device)
        yy = (y0.long() - radius).view(p, 1, 1) + offs.view(1, side, 1)
        xx = (x0.long() - radius).view(p, 1, 1) + offs.view(1, 1, side)
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = torch.where(inside, yy * w + xx, torch.full_like(yy, h * w))  # h w: a spare slot
        d = torch.zeros((p, h * w + 1), dtype=torch.float32, device=g.device)
        d.scatter_(1, idx.view(p, -1), win.view(p, -1))
        out.append(d[:, : h * w].view(p, h, w))
    return out


def corr_lookup_backward(
    g: torch.Tensor, sizes: Sequence[Tuple[int, int]], coords: torch.Tensor, radius: int = 4,
) -> List[torch.Tensor]:
    """d pyramid of `corr_lookup` for g = d out: the backward CUDA kernel
    for CUDA tensors (g and coords float32, contiguous; one launch for every
    level, inside the span `vstab.flow.raft.lookup_bwd` with its
    `lookup_bwd_bytes`), the plain version for CPU tensors; anything else
    raises."""
    if g.is_cuda:
        check_cuda("corr_lookup_backward", {"g": g, "coords": coords}, (torch.float32,))
        levels = len(sizes)
        n, h, w, two = coords.shape
        npix = n * h * w
        if two != 2 or tuple(g.shape) != (n, h, w, levels * (2 * radius + 1) ** 2):
            raise ValueError(
                f"corr_lookup_backward: g {tuple(g.shape)} and coords {tuple(coords.shape)} do not "
                f"belong to one lookup of {levels} levels at radius {radius}"
            )
        if not 1 <= levels <= MAX_LEVELS or not 1 <= radius <= MAX_RADIUS:
            raise ValueError(f"corr_lookup_backward: {levels} levels, radius {radius}")
        out = [torch.empty((npix, hl, wl), dtype=torch.float32, device=g.device) for hl, wl in sizes]
        ptrs = [t.data_ptr() for t in out] + [None] * (MAX_LEVELS - levels)
        flat = [s for hw in sizes for s in hw] + [0, 0] * (MAX_LEVELS - levels)
        if npix:
            with trace.span("vstab.flow.raft.lookup_bwd", device=True,
                            lookup_bwd_bytes=lookup_bwd_bytes(npix, levels, radius)):
                KERNEL_BWD(*ptrs, *flat, levels, radius, coords.data_ptr(), g.data_ptr(), npix,
                           stream_ptr(g))
        return out
    if g.device.type == "cpu":
        return corr_lookup_backward_plain(g, sizes, coords, radius)
    raise ValueError(f"corr_lookup_backward: no kernel for device {g.device}")


def _launch(pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    n, h, w, _ = coords.shape
    levels, npix = len(pyramid), n * h * w
    out = torch.empty((n, h, w, levels * (2 * radius + 1) ** 2), dtype=out_dtype,
                      device=coords.device)
    ptrs = [t.data_ptr() for t in pyramid] + [None] * (MAX_LEVELS - levels)
    sizes = [s for t in pyramid for s in t.shape[1:]] + [0, 0] * (MAX_LEVELS - levels)
    if npix:
        KERNEL(*ptrs, *sizes, levels, radius, coords.data_ptr(), out.data_ptr(), npix,
               DTYPE_CODES[out_dtype], stream_ptr(coords))
    return out


class CorrLookupFn(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient in the
    pyramid (CUDA tensors only; `corr_lookup` has checked them)."""

    @staticmethod
    def forward(ctx, coords, radius, out_dtype, *pyramid):
        if ctx.needs_input_grad[0]:
            raise ValueError(
                "corr_lookup: the coordinates get no gradient (RAFT detaches them); detach them first"
            )
        ctx.radius = radius
        ctx.sizes = [tuple(t.shape[1:]) for t in pyramid]
        ctx.save_for_backward(coords)
        return _launch(pyramid, coords, radius, out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        if g.dtype != torch.float32:
            raise TypeError(f"corr_lookup: the backward takes a float32 gradient, got {g.dtype}")
        # autograd may hand over a strided view: made contiguous, not refused
        grads = corr_lookup_backward(g.contiguous(), ctx.sizes, coords, ctx.radius)
        need = ctx.needs_input_grad[3:]
        return (None, None, None, *[d if want else None for d, want in zip(grads, need)])


def corr_lookup(
    pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int = 4,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """[N,H,W,levels (2r+1)^2] samples of the pyramid around coords: the
    CUDA kernel for CUDA tensors (float32 levels [N H W, H_l, W_l] and coords
    [N,H,W,2], contiguous; 1 to 4 levels, radius 1 to 4; out float32 or
    bfloat16; differentiable in the pyramid through `CorrLookupFn` where
    autograd records a graph), the plain version for CPU tensors; anything
    else raises."""
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
        if torch.is_grad_enabled() and (coords.requires_grad or any(t.requires_grad for t in pyramid)):
            return CorrLookupFn.apply(coords, radius, out_dtype, *pyramid)
        return _launch(pyramid, coords, radius, out_dtype)
    if coords.device.type == "cpu":
        return corr_lookup_plain(pyramid, coords, radius, out_dtype)
    raise ValueError(f"corr_lookup: no kernel for device {coords.device}")


__all__ = [
    "KERNEL",
    "KERNEL_BWD",
    "CorrLookupFn",
    "corr_lookup",
    "corr_lookup_backward",
    "corr_lookup_backward_plain",
    "corr_lookup_plain",
    "lookup_bwd_bytes",
]
