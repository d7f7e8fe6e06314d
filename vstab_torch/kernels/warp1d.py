"""Separable 1D warps and the two-pass full-frame render warp.

`vwarp` and `hwarp` launch the CUDA kernels of `csrc/warp1d.cu` for CUDA
tensors and run `vwarp_plain` / `hwarp_plain` for CPU tensors.

Replace `vstab/kernels/warp1d.py:vwarp_pallas` and `hwarp_pallas`. Bound on
the H100: bytes (frame and field read once, output written once). Design
(see the source's header): `vwarp` gives each output row to a few blocks that
walk over it in chunks, a thread per float, frame and row taken from the
launch grid; a warp's two tap loads and its store are 128 contiguous bytes
wherever its pixels share their tap rows, and the next chunk's field values
are loaded while this chunk's taps are in flight. Frames of 2 GB or more take
a per-element kernel. `hwarp` gives each image row to one block, which copies
the row into shared memory with 16-byte `cp.async` copies, gathers both taps
of every pixel there (one thread per pixel, all channels) and writes the row
back in 16-byte stores, so device traffic is the bound itself. Rows that do
not start on a 16-byte boundary move their first and last floats in 4-byte
copies; rows too long for shared memory take a per-element kernel.

A general smooth warp factorizes (see `vstab/kernels/warp1d.py`) into
  1. a per-frame integer mean shift (roll),
  2. a vertical 1D pass   A(r,x) = F(r + vv(r,x), x),
  3. a horizontal 1D pass out(y,x) = A(y, x + u(y,x)),
with vv the vertical field resampled at the inverse of the horizontal map
(fixed-point iteration). `warp_twopass` equals the ideal backward bilinear
warp wherever `twopass_validity` is 1; callers mask the rest.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vstab_torch.kernels._build import CudaKernel, check_cuda, stream_ptr
from vstab_torch.kernels.warp import warp_validity

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
VWARP = CudaKernel("warp1d", "vstab_vwarp", _ARGTYPES)
HWARP = CudaKernel("warp1d", "vstab_hwarp", _ARGTYPES)
_MODES = {"edge": 0, "wrap": 1}


def _fix(i: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    # torch's % on integer tensors is floored, like jnp's.
    return i % n if mode == "wrap" else i.clamp(0, n - 1)


def vwarp_plain(
    img: torch.Tensor, v: torch.Tensor, max_disp: int = 16, mode: str = "edge"
) -> torch.Tensor:
    """Vertical 1D warp [N,H,W,C] by v [N,H,W]: the arithmetic of `vwarp_xla`."""
    n, h, w, c = img.shape
    yy = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    sy = yy + v.float().clamp(-max_disp, max_disp)
    y0f = torch.floor(sy)
    fy = (sy - y0f)[..., None]
    y0 = y0f.long()
    a = torch.gather(img, 1, _fix(y0, h, mode)[..., None].expand(n, h, w, c))
    b = torch.gather(img, 1, _fix(y0 + 1, h, mode)[..., None].expand(n, h, w, c))
    return ((1.0 - fy) * a.float() + fy * b.float()).to(img.dtype)


def hwarp_plain(
    img: torch.Tensor, u: torch.Tensor, max_disp: int = 16, mode: str = "edge"
) -> torch.Tensor:
    """Horizontal 1D warp [N,H,W,C] by u [N,H,W]: the arithmetic of `hwarp_xla`."""
    n, h, w, c = img.shape
    xx = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    sx = xx + u.float().clamp(-max_disp, max_disp)
    x0f = torch.floor(sx)
    fx = (sx - x0f)[..., None]
    x0 = x0f.long()
    a = torch.gather(img, 2, _fix(x0, w, mode)[..., None].expand(n, h, w, c))
    b = torch.gather(img, 2, _fix(x0 + 1, w, mode)[..., None].expand(n, h, w, c))
    return ((1.0 - fx) * a.float() + fx * b.float()).to(img.dtype)


def _launch_1d(kernel, name, img, field, max_disp, mode):
    check_cuda(name, {"img": img, "field": field}, (torch.float32,))
    if img.dim() != 4 or tuple(field.shape) != tuple(img.shape[:3]):
        raise ValueError(
            f"{name}: img {tuple(img.shape)} needs a field [N,H,W], got {tuple(field.shape)}"
        )
    if mode not in _MODES:
        raise ValueError(f"{name}: mode must be 'edge' or 'wrap', got {mode!r}")
    n, h, w, c = img.shape
    out = torch.empty_like(img)
    if out.numel():
        kernel(
            img.data_ptr(), field.data_ptr(), out.data_ptr(), n, h, w, c,
            float(max_disp), _MODES[mode], stream_ptr(img),
        )
    return out


def vwarp(
    img: torch.Tensor, v: torch.Tensor, max_disp: int = 16, mode: str = "edge"
) -> torch.Tensor:
    """Vertical 1D warp, |v| clipped to max_disp: the kernel for CUDA
    tensors (f32, contiguous), the plain version for CPU tensors."""
    if img.is_cuda:
        return _launch_1d(VWARP, "vwarp", img, v, max_disp, mode)
    if img.device.type == "cpu":
        return vwarp_plain(img, v, max_disp, mode)
    raise ValueError(f"vwarp: no kernel for device {img.device}")


def hwarp(
    img: torch.Tensor, u: torch.Tensor, max_disp: int = 16, mode: str = "edge"
) -> torch.Tensor:
    """Horizontal 1D warp, |u| clipped to max_disp: the kernel for CUDA
    tensors (f32, contiguous), the plain version for CPU tensors."""
    if img.is_cuda:
        return _launch_1d(HWARP, "hwarp", img, u, max_disp, mode)
    if img.device.type == "cpu":
        return hwarp_plain(img, u, max_disp, mode)
    raise ValueError(f"hwarp: no kernel for device {img.device}")


def _mean_shift(flow: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, v, mu, mv): the flow components and their per-frame means rounded
    half to even (as jnp.round does)."""
    u = flow[..., 0].float()
    v = flow[..., 1].float()
    return u, v, torch.round(u.mean(dim=(1, 2))), torch.round(v.mean(dim=(1, 2)))


def _roll_and_wrap_pad(
    frames: torch.Tensor, mu: torch.Tensor, mv: torch.Tensor, dpad: int
) -> torch.Tensor:
    """Frame i rolled by (-mv[i], -mu[i]) along (rows, columns), then
    wrap-padded by dpad columns on both sides: [N,H,W,C] -> [N,H,W+2*dpad,C],
    out[i, y, x] = frames[i, (y + mv[i]) % H, (x - dpad + mu[i]) % W]."""
    n, h, w, _ = frames.shape
    dev = frames.device
    rows = (torch.arange(h, device=dev)[None] + mv.long()[:, None]) % h  # [N,H]
    cols = (torch.arange(-dpad, w + dpad, device=dev)[None] % w + mu.long()[:, None]) % w
    return frames[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]


def warp_twopass(
    frames: torch.Tensor,
    flow: torch.Tensor,
    max_disp: int = 16,
    inv_iters: Optional[int] = None,
) -> torch.Tensor:
    """Backward warp frames [N,H,W,C] by flow [N,H,W,2] via mean shift +
    vertical pass + horizontal pass, mirroring `vstab.kernels.warp1d.
    warp_twopass` step for step. inv_iters defaults to 2, or 3 when
    max_disp > 63."""
    if inv_iters is None:
        inv_iters = 2 if max_disp <= 63 else 3
    n, h, w, c = frames.shape
    u, v, mu, mv = _mean_shift(flow)
    ur = u - mu[:, None, None]
    vr = v - mv[:, None, None]

    # F_m(q) = F(q + m): each frame rolled by -m (see the reference for why
    # wrap-mode taps in the vertical pass then recover the content), and the
    # working domain extended horizontally by dpad columns: the image
    # wrap-padded (true rolled content), the fields edge-extended. Roll and
    # wrap-pad are one gather with indices computed on the device, so the
    # host does not wait for the per-frame shifts.
    dpad = max_disp + 1
    ur_e = F.pad(ur, (dpad, dpad), mode="replicate")
    vr_e = F.pad(vr, (dpad, dpad), mode="replicate")
    fm_e = _roll_and_wrap_pad(frames, mu, mv, dpad)

    def hw1(field, disp):  # horizontal warp of a single-channel field
        return hwarp(field[..., None].contiguous(), disp, max_disp=max_disp)[..., 0]

    delta = -ur_e
    for _ in range(max(0, inv_iters - 1)):
        delta = -hw1(ur_e, delta)
    vv = hw1(vr_e, delta)
    a = vwarp(fm_e, vv.contiguous(), max_disp=max_disp, mode="wrap")
    out_e = hwarp(a, ur_e, max_disp=max_disp)
    return out_e[:, :, dpad : dpad + w]


def twopass_validity(
    shape_hw: Tuple[int, int], flow: torch.Tensor, max_disp: int = 16
) -> torch.Tensor:
    """[N,H,W] float mask: 1 where `warp_twopass` equals the ideal backward
    bilinear warp — all four taps in-bounds and the per-frame mean-removed
    residual within max_disp."""
    u, v, mu, mv = _mean_shift(flow)
    ok = ((u - mu[:, None, None]).abs() <= max_disp) & (
        (v - mv[:, None, None]).abs() <= max_disp
    )
    return warp_validity(shape_hw, flow) * ok.float()


__all__ = [
    "HWARP",
    "VWARP",
    "hwarp",
    "hwarp_plain",
    "twopass_validity",
    "vwarp",
    "vwarp_plain",
    "warp_twopass",
]
