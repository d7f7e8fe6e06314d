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

Convention: output[n,y,x] samples input at (x + flow[...,0], y + flow[...,1]);
out-of-bounds taps clamp to the border.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vstab_torch.kernels._build import (
    DTYPE_CODES,
    CudaKernel,
    check_cuda,
    stream_ptr,
)

KERNEL = CudaKernel(
    "warp",
    "vstab_bilinear_warp",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)


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


def bilinear_warp(img: torch.Tensor, flow: torch.Tensor, max_disp: int = 8) -> torch.Tensor:
    """Backward warp [N,H,W,C] by [N,H,W,2]. CUDA tensors (f32 or bf16,
    contiguous) go through the kernel with |flow| clipped to max_disp; CPU
    tensors through the unclipped plain version; anything else raises."""
    if img.is_cuda:
        check_cuda(
            "bilinear_warp", {"img": img, "flow": flow}, (torch.float32, torch.bfloat16)
        )
        if img.dim() != 4 or tuple(flow.shape) != tuple(img.shape[:3]) + (2,):
            raise ValueError(
                f"bilinear_warp: img {tuple(img.shape)} needs flow [N,H,W,2], "
                f"got {tuple(flow.shape)}"
            )
        n, h, w, c = img.shape
        out = torch.empty_like(img)
        if out.numel():
            KERNEL(
                img.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c,
                float(max_disp), DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype],
                stream_ptr(img),
            )
        return out
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


__all__ = ["KERNEL", "bilinear_warp", "bilinear_warp_plain", "warp_validity"]
