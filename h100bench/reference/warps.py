"""Frozen plain versions of the four operations the program runs as CUDA
kernels: the cost volume, the bounded bilinear feature warp, and the
vertical and horizontal 1-D warps with the two-pass render warp built on
them. Every function computes in float32 and is differentiable by autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """[N,H,W,C] x [N,H,W,C] -> [N,H,W,(2r+1)^2]: out[..., k(dy,dx)] =
    mean_c f1[y,x,c] * f2[y+dy,x+dx,c], f2 zero outside its bounds."""
    _, h, w, _ = f1.shape
    r = radius
    a = f1.float()
    f2p = F.pad(f2.float(), (0, 0, r, r, r, r))
    outs = [
        (a * f2p[:, dy : dy + h, dx : dx + w]).mean(dim=-1)
        for dy in range(2 * r + 1)
        for dx in range(2 * r + 1)
    ]
    return torch.stack(outs, dim=-1)


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy = torch.arange(h, dtype=torch.float32, device=device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=device).view(1, 1, w)
    return xx, yy


def bilinear_warp(img: torch.Tensor, flow: torch.Tensor, max_disp: float = None) -> torch.Tensor:
    """Backward bilinear warp of [N,H,W,C] by flow [N,H,W,2] with the four
    taps clamped to the image edge; each flow component clipped to
    +-max_disp first when one is given (the gradient is zero where it clips)."""
    n, h, w, c = img.shape
    flow = flow.float()
    if max_disp is not None:
        flow = flow.clamp(-max_disp, max_disp)
    xx, yy = _grid(h, w, img.device)
    sx = xx + flow[..., 0]
    sy = yy + flow[..., 1]
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    fx = (sx - x0f)[..., None]
    fy = (sy - y0f)[..., None]
    x0 = x0f.long()
    y0 = y0f.long()
    flat = img.float().reshape(n, h * w, c)

    def tap(yi, xi):
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        idx = lin.reshape(n, h * w, 1).expand(n, h * w, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    return (
        (1 - fx) * (1 - fy) * tap(y0, x0)
        + fx * (1 - fy) * tap(y0, x0 + 1)
        + (1 - fx) * fy * tap(y0 + 1, x0)
        + fx * fy * tap(y0 + 1, x0 + 1)
    )


def warp_validity(shape_hw: Tuple[int, int], flow: torch.Tensor) -> torch.Tensor:
    """[N,H,W] float mask: 1 where all four taps lie inside the image."""
    h, w = shape_hw
    xx, yy = _grid(h, w, flow.device)
    sx = xx + flow[..., 0].float()
    sy = yy + flow[..., 1].float()
    return ((sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)).float()


def _fix(i: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    return i % n if mode == "wrap" else i.clamp(0, n - 1)


def vwarp(img: torch.Tensor, v: torch.Tensor, max_disp: int, mode: str = "edge") -> torch.Tensor:
    """out[n,y,x] = img at row y + clip(v[n,y,x]), linear between two rows."""
    n, h, w, c = img.shape
    yy = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    sy = yy + v.float().clamp(-max_disp, max_disp)
    y0f = torch.floor(sy)
    fy = (sy - y0f)[..., None]
    y0 = y0f.long()
    a = torch.gather(img, 1, _fix(y0, h, mode)[..., None].expand(n, h, w, c))
    b = torch.gather(img, 1, _fix(y0 + 1, h, mode)[..., None].expand(n, h, w, c))
    return (1.0 - fy) * a + fy * b


def hwarp(img: torch.Tensor, u: torch.Tensor, max_disp: int, mode: str = "edge") -> torch.Tensor:
    """out[n,y,x] = img at column x + clip(u[n,y,x]), linear between two columns."""
    n, h, w, c = img.shape
    xx = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    sx = xx + u.float().clamp(-max_disp, max_disp)
    x0f = torch.floor(sx)
    fx = (sx - x0f)[..., None]
    x0 = x0f.long()
    a = torch.gather(img, 2, _fix(x0, w, mode)[..., None].expand(n, h, w, c))
    b = torch.gather(img, 2, _fix(x0 + 1, w, mode)[..., None].expand(n, h, w, c))
    return (1.0 - fx) * a + fx * b


def _mean_shift(flow: torch.Tensor):
    u = flow[..., 0].float()
    v = flow[..., 1].float()
    return u, v, torch.round(u.mean(dim=(1, 2))), torch.round(v.mean(dim=(1, 2)))


def warp_twopass(frames: torch.Tensor, flow: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Backward warp of frames [N,H,W,C] by a smooth flow [N,H,W,2]: a
    per-frame integer mean shift, then a vertical and a horizontal 1-D pass,
    the vertical field taken at the inverse of the horizontal map (fixed-point
    iteration: 2 rounds up to max_disp 63, 3 above)."""
    inv_iters = 2 if max_disp <= 63 else 3
    n, h, w, c = frames.shape
    u, v, mu, mv = _mean_shift(flow)
    ur = u - mu[:, None, None]
    vr = v - mv[:, None, None]
    dpad = max_disp + 1
    ur_e = F.pad(ur, (dpad, dpad), mode="replicate")
    vr_e = F.pad(vr, (dpad, dpad), mode="replicate")
    dev = frames.device
    rows = (torch.arange(h, device=dev)[None] + mv.long()[:, None]) % h
    cols = (torch.arange(-dpad, w + dpad, device=dev)[None] % w + mu.long()[:, None]) % w
    fm_e = frames[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]

    def hw1(field, disp):
        return hwarp(field[..., None], disp, max_disp)[..., 0]

    delta = -ur_e
    for _ in range(inv_iters - 1):
        delta = -hw1(ur_e, delta)
    vv = hw1(vr_e, delta)
    a = vwarp(fm_e, vv, max_disp, mode="wrap")
    return hwarp(a, ur_e, max_disp)[:, :, dpad : dpad + w]


def twopass_validity(shape_hw: Tuple[int, int], flow: torch.Tensor, max_disp: int) -> torch.Tensor:
    """[N,H,W] mask: 1 where the two-pass warp equals the ideal bilinear warp."""
    u, v, mu, mv = _mean_shift(flow)
    ok = ((u - mu[:, None, None]).abs() <= max_disp) & ((v - mv[:, None, None]).abs() <= max_disp)
    return warp_validity(shape_hw, flow) * ok.float()
