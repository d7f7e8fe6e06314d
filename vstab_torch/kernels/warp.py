"""Bounded backward bilinear warp of feature maps, and its validity mask.

`bilinear_warp` launches the CUDA kernel of `csrc/warp.cu` for CUDA
tensors, which clips the flow to +-max_disp as the TPU kernel does, and runs
`bilinear_warp_plain` (unclipped) for CPU tensors, as the JAX package's CPU
path calls `bilinear_warp_xla` unclipped (`vstab/kernels/warp.py:376-378`).

Replaces `vstab/kernels/warp.py:bilinear_warp_pallas`. Bound on the H100:
bytes (image and flow read once, output written once). Design (see the
source's header): a thread owns one 16-byte vector of a pixel's channels (8
bf16 or 4 f32), computes the pixel's taps and weights once, reads the four
taps as 16-byte loads and writes one 16-byte vector; frame, row and position
come from the launch grid, no index is divided out. That kernel serves channel
counts that are a multiple of the vector length on 16-byte aligned tensors;
any other call (C = 3, a view that starts mid-storage) goes to the kernel
with one thread per output element. Which one runs is decided in the C entry
point from the shape and the addresses.

Gradient: the CUDA path always goes through `BilinearWarpFn` (without a
graph, as under `no_grad` or `inference_mode`, that is the forward launch and
nothing else), whose backward is `bilinear_warp_backward`: one launch of
`vstab_bilinear_warp_bwd` of the same source, whose route the source's
`vstab_bilinear_warp_bwd_route` names from the shape, `max_disp`, the
gradients asked for and the addresses. The training network's warp (both
gradients, max_disp 8) takes the gather: a block stages its window's taps,
each source pixel sums its contributors in increasing output index, so the
image gradient is written once in the image's dtype and is the same to the
bit run to run and for an image alone or in a batch; the flow's gradient
comes from 16-byte vectors and a shuffle reduction in a fixed order, zero
where the forward clipped the flow. The scatter route, the first version,
takes the rest: the image's gradient under a larger `max_disp` such as
`UNBOUNDED`, a channel count off the vector length or an unaligned view,
with f32 atomics into a buffer this wrapper zeroes and rounds; and the
flow's gradient alone (the photometric loss), which asks for no image
gradient and so is a gather with no atomics and no buffer. The plain version does not clip, so the two
gradients differ exactly where |flow| > max_disp.
`bilinear_warp_backward_plain` writes the unclipped gradients out with
gathers and a `scatter_add_`. `UNBOUNDED` is a `max_disp` under which the
kernel clips nothing: the unclipped warp on the card.

Convention: output[n,y,x] samples input at (x + flow[...,0], y + flow[...,1]);
out-of-bounds taps clamp to the border.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from vstab_torch.kernels._build import (
    DTYPE_CODES,
    CudaKernel,
    check_cuda,
    library,
    stream_ptr,
)

KERNEL = CudaKernel(
    "warp",
    "vstab_bilinear_warp",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)
KERNEL_BWD = CudaKernel(
    "warp",
    "vstab_bilinear_warp_bwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)
UNBOUNDED = 1 << 20  # pixels: a max_disp that clips no flow
# Routes of vstab_bilinear_warp_bwd_route (csrc/warp.cu, BwdRoute)
ROUTE_NONE, ROUTE_GATHER, ROUTE_SCATTER = range(3)


@functools.lru_cache(maxsize=None)
def _route_fn():
    fn = library("warp").vstab_bilinear_warp_bwd_route
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


def backward_route(
    g: torch.Tensor, img: torch.Tensor, flow: torch.Tensor, max_disp: float,
    need: Tuple[bool, bool],
) -> int:
    """The route (ROUTE_*) that `vstab_bilinear_warp_bwd` takes for these
    CUDA tensors: a question to the built library, no launch."""
    route = _route_fn()(
        g.data_ptr(), img.data_ptr(), flow.data_ptr(), *img.shape, float(max_disp),
        int(need[0]), int(need[1]), DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype],
    )
    if route < 0:
        raise TypeError(f"bilinear_warp_backward: no route for {img.dtype} and {flow.dtype}")
    return route


def _grid(n_rows: int, n_cols: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(n_rows, dtype=torch.float32, device=device).view(1, n_rows, 1)
    xx = torch.arange(n_cols, dtype=torch.float32, device=device).view(1, 1, n_cols)
    return xx, yy


def bilinear_warp_plain(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Unbounded backward bilinear warp, [N,H,W,C] by flow [N,H,W,2]: the
    arithmetic of `bilinear_warp_xla` (four edge-clamped gathers) in torch."""
    n, h, w, c = img.shape
    flow = flow.float()
    xx, yy = _grid(h, w, img.device)
    sx = xx + flow[..., 0]
    sy = yy + flow[..., 1]
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    fx = (sx - x0f)[..., None]
    fy = (sy - y0f)[..., None]
    x0 = x0f.long()
    y0 = y0f.long()
    flat = img.reshape(n, h * w, c)

    def tap(yi, xi):
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        idx = lin.reshape(n, h * w, 1).expand(n, h * w, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    out = (
        (1 - fx) * (1 - fy) * tap(y0, x0)
        + fx * (1 - fy) * tap(y0, x0 + 1)
        + (1 - fx) * fy * tap(y0 + 1, x0)
        + fx * fy * tap(y0 + 1, x0 + 1)
    )
    return out.to(img.dtype)


def _taps(flow: torch.Tensor, h: int, w: int):
    """Clamped tap indices and fractions of `bilinear_warp_plain`."""
    xx, yy = _grid(h, w, flow.device)
    sx = xx + flow[..., 0]
    sy = yy + flow[..., 1]
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    x0, y0 = x0f.long(), y0f.long()
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    return (sx - x0f)[..., None], (sy - y0f)[..., None], (ya, yb), (xa, xb)


def bilinear_warp_backward_plain(
    g: torch.Tensor, img: torch.Tensor, flow: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dimg, dflow) of `bilinear_warp_plain` for g = dL/dout [N,H,W,C]:
    every output pixel adds g times its weight to each of its four clamped
    taps, and the flow's gradient is the sum over channels of g times the
    tap differences. Sums in f32; dimg in img's dtype, dflow in flow's."""
    n, h, w, c = img.shape
    gf = g.float().reshape(n, h * w, c)
    flat = img.float().reshape(n, h * w, c)
    fx, fy, (ya, yb), (xa, xb) = _taps(flow.float(), h, w)
    dimg = torch.zeros_like(flat)
    taps = {}
    for (iy, yi), wy in zip(enumerate((ya, yb)), (1 - fy, fy)):
        for (ix, xi), wx in zip(enumerate((xa, xb)), (1 - fx, fx)):
            idx = (yi * w + xi).reshape(n, h * w, 1).expand(n, h * w, c)
            dimg.scatter_add_(1, idx, gf * (wy * wx).reshape(n, h * w, 1))
            taps[iy, ix] = torch.gather(flat, 1, idx)
    fxf, fyf = fx.reshape(n, h * w, 1), fy.reshape(n, h * w, 1)
    du = (gf * ((1 - fyf) * (taps[0, 1] - taps[0, 0]) + fyf * (taps[1, 1] - taps[1, 0]))).sum(-1)
    dv = (gf * ((1 - fxf) * (taps[1, 0] - taps[0, 0]) + fxf * (taps[1, 1] - taps[0, 1]))).sum(-1)
    dflow = torch.stack([du, dv], dim=-1).reshape(n, h, w, 2)
    return dimg.reshape(n, h, w, c).to(img.dtype), dflow.to(flow.dtype)


def bilinear_warp_backward(
    g: torch.Tensor, img: torch.Tensor, flow: torch.Tensor, max_disp: int = 8,
    need: Tuple[bool, bool] = (True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dimg, dflow) of `bilinear_warp` for g = dL/dout, None where `need` is
    False: the backward CUDA kernel for CUDA tensors (the flow's gradient is
    zero where |flow| > max_disp, as the forward clipped it there), the
    unclipped plain version for CPU tensors; anything else raises."""
    if img.is_cuda:
        check_cuda(
            "bilinear_warp_backward", {"img": img, "flow": flow}, (torch.float32, torch.bfloat16)
        )
        check_cuda("bilinear_warp_backward", {"g": g, "img": img}, (img.dtype,))
        if img.dim() != 4 or g.shape != img.shape or tuple(flow.shape) != tuple(img.shape[:3]) + (2,):
            raise ValueError(
                f"bilinear_warp_backward: g {tuple(g.shape)}, img {tuple(img.shape)}, "
                f"flow {tuple(flow.shape)} do not belong to one warp"
            )
        n, h, w, c = img.shape
        dimg = acc = None
        if need[0]:  # only the scatter route wants a zeroed f32 buffer, rounded once
            if backward_route(g, img, flow, max_disp, need) == ROUTE_SCATTER:
                dimg = acc = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
            else:
                dimg = torch.empty_like(img)
        dflow = torch.empty_like(flow) if need[1] else None
        if img.numel() and (need[0] or need[1]):
            KERNEL_BWD(
                g.data_ptr(), img.data_ptr(), flow.data_ptr(),
                None if dimg is None else dimg.data_ptr(),
                None if dflow is None else dflow.data_ptr(),
                n, h, w, c, float(max_disp), DTYPE_CODES[img.dtype],
                DTYPE_CODES[flow.dtype], stream_ptr(img),
            )
        if acc is not None and img.dtype != torch.float32:
            dimg = acc.to(img.dtype)
        return dimg, dflow
    if img.device.type == "cpu":
        dimg, dflow = bilinear_warp_backward_plain(g, img, flow)
        return (dimg if need[0] else None), (dflow if need[1] else None)
    raise ValueError(f"bilinear_warp_backward: no kernel for device {img.device}")


class BilinearWarpFn(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (CUDA
    tensors only; `bilinear_warp` has checked them)."""

    @staticmethod
    def forward(ctx, img, flow, max_disp):
        ctx.max_disp = max_disp
        ctx.save_for_backward(img, flow)
        n, h, w, c = img.shape
        out = torch.empty_like(img)
        if out.numel():
            KERNEL(
                img.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c,
                float(max_disp), DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype],
                stream_ptr(img),
            )
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        # autograd may hand over a strided view: made contiguous, not refused
        dimg, dflow = bilinear_warp_backward(
            g.contiguous(), img, flow, ctx.max_disp, ctx.needs_input_grad[:2]
        )
        return dimg, dflow, None


def bilinear_warp(img: torch.Tensor, flow: torch.Tensor, max_disp: int = 8) -> torch.Tensor:
    """Backward warp [N,H,W,C] by [N,H,W,2]. CUDA tensors (f32 or bf16,
    contiguous) go through the kernel with |flow| clipped to max_disp
    (differentiable through `BilinearWarpFn`); CPU tensors through the
    unclipped plain version; anything else raises."""
    if img.is_cuda:
        check_cuda(
            "bilinear_warp", {"img": img, "flow": flow}, (torch.float32, torch.bfloat16)
        )
        if img.dim() != 4 or tuple(flow.shape) != tuple(img.shape[:3]) + (2,):
            raise ValueError(
                f"bilinear_warp: img {tuple(img.shape)} needs flow [N,H,W,2], "
                f"got {tuple(flow.shape)}"
            )
        return BilinearWarpFn.apply(img, flow, max_disp)
    if img.device.type == "cpu":
        return bilinear_warp_plain(img, flow)
    raise ValueError(f"bilinear_warp: no kernel for device {img.device}")


def warp_validity(shape_hw: Tuple[int, int], flow: torch.Tensor) -> torch.Tensor:
    """[N,H,W] float mask: 1 where all 4 taps were in-bounds."""
    h, w = shape_hw
    xx, yy = _grid(h, w, flow.device)
    sx = xx + flow[..., 0].float()
    sy = yy + flow[..., 1].float()
    return ((sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)).float()


__all__ = [
    "KERNEL",
    "KERNEL_BWD",
    "ROUTE_GATHER",
    "ROUTE_NONE",
    "ROUTE_SCATTER",
    "UNBOUNDED",
    "BilinearWarpFn",
    "backward_route",
    "bilinear_warp",
    "bilinear_warp_backward",
    "bilinear_warp_backward_plain",
    "bilinear_warp_plain",
    "warp_validity",
]
