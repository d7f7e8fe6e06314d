"""Full-frame stabilized renderer, the port of `vstab/render/render.py`.

It takes per-frame affine warps [T,2,3] (affine smoothing path) or per-frame
grid displacement fields [T,GH,GW,2] (sparse-LS path), turns them into a
dense backward-warp flow, samples the frames and applies the crop policy.

Frames are sampled once by `warp_twopass` (mean shift plus the vertical and
horizontal 1D kernels), the crop zoom is a vertical then a horizontal
two-tap pass on the same 1D kernels in edge mode (f32), and pixels whose
ideal sample left the frame are filled with `border_value` through the
validity mask of the exact flow.
"""

from __future__ import annotations

import functools
import logging
from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from vstab_torch.core.config import RenderConfig
from vstab_torch.core.precision import einsum_f32
from vstab_torch.core.types import apply_affine
from vstab_torch.kernels import hwarp, twopass_validity, vwarp, warp_twopass
from vstab_torch.utils import trace

log = logging.getLogger("vstab_torch.render")


def _base_grid(h: int, w: int, device):
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return xx, yy


def affine_to_flow(transforms: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[T,2,3] output->input affines -> backward-warp flow [T,H,W,2]."""
    xx, yy = _base_grid(h, w, transforms.device)
    pts = torch.stack([xx, yy], dim=-1)  # [H,W,2]
    return apply_affine(transforms[:, None, None], pts[None]) - pts[None]


def grid_to_flow(disp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[T,GH,GW,2] vertex displacement grid -> dense flow [T,H,W,2] by
    bilinear upsampling with half-pixel centres (`align_corners=False`),
    which is what `jax.image.resize` computes."""
    out = F.interpolate(
        disp.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False
    )
    return out.permute(0, 2, 3, 1)


def _zoom_disp(n: int, scale: torch.Tensor) -> torch.Tensor:
    """[n] f32 displacements src(i) - i of the centered scale map
    src(i) = clamp(c + scale*(i-c), 0, n-1)."""
    i = torch.arange(n, dtype=torch.float32, device=scale.device)
    ctr = (n - 1) / 2.0
    return torch.clamp(ctr + scale.float() * (i - ctr), 0.0, n - 1.0) - i


def zoom_fields(shape_thw, scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The zoom's displacement fields src(i) - i for frames [T,H,W,...]:
    (vertical [T,H,W], constant along x; horizontal [T,H,W], constant along
    y), contiguous, made on the scale's device without reading it back."""
    t, h, w = shape_thw
    fy = _zoom_disp(h, scale)[None, :, None].expand(t, h, w).contiguous()
    fx = _zoom_disp(w, scale)[None, None, :].expand(t, h, w).contiguous()
    return fy, fx


def zoom_resample(
    img: torch.Tensor, scale: torch.Tensor,
    fields: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Centered zoom-in resample out(p) = img(c + scale*(p-c)) for [T,H,W,C]:
    the bilinear resample as a vertical then a horizontal two-tap pass in
    edge mode (the clamped source's taps land on the edge pixel), in f32.
    `fields` (`zoom_fields(img.shape[:3], scale)`) lets images of one shape
    share them; the bound on |field| is the axis length, so it never clips."""
    t, h, w, _ = img.shape
    fy, fx = zoom_fields((t, h, w), scale) if fields is None else fields
    tmp = vwarp(img.contiguous(), fy, max_disp=float(h), mode="edge")
    return hwarp(tmp, fx, max_disp=float(w), mode="edge")


def _auto_scale_per_frame(flow: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Per-frame smallest centered zoom s<=1 keeping sampled coords in-bounds
    for every pixel of that frame: [T,H,W,2] -> [T]."""
    t, h, w, _ = flow.shape
    xx, yy = _base_grid(h, w, flow.device)
    sx = xx[None] + flow[..., 0]
    sy = yy[None] + flow[..., 1]
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0
    over_x = torch.clamp(torch.maximum(-sx, sx - (w - 1)), min=0.0)
    over_y = torch.clamp(torch.maximum(-sy, sy - (h - 1)), min=0.0)
    rx = torch.abs(xx - cx) + 1.0
    ry = torch.abs(yy - cy) + 1.0
    sreq = torch.minimum((rx[None] - over_x) / rx[None], (ry[None] - over_y) / ry[None])
    return torch.clamp(sreq.amin(dim=(1, 2)) - margin, 0.5, 1.0)


def auto_crop_scales(
    flows: Iterable[torch.Tensor], cfg: RenderConfig
) -> Optional[Iterator[torch.Tensor]]:
    """The 'auto' crop's per-frame zoom bounds [B] of each warp flow
    [B,H,W,2] of `flows`, as asked for; None, `flows` untouched, for the
    other crop modes. A clip rendered in parts (blocks, ranks) passes the
    minimum over its real frames to `render_stabilized` as `scale`."""
    if cfg.crop_mode != "auto":
        return None
    return map(_auto_scale_per_frame, flows)


def fixed_crop_scale(cfg: RenderConfig, device) -> Optional[torch.Tensor]:
    """The 'fixed' crop's zoom, a 0-dim f32 tensor on `device`, else None. A
    clip rendered in many dispatches makes it once: copying a host number to
    a CUDA device waits for the device."""
    if cfg.crop_mode != "fixed":
        return None
    return torch.as_tensor(cfg.fixed_crop_ratio, dtype=torch.float32, device=device)


# Buckets of the render warp's displacement bound (see the reference).
_DISP_BUCKETS = (16, 24, 32, 48, 63, 127, 255)


@functools.lru_cache(maxsize=None)
def _resize_mean_weights(g: int, n: int) -> tuple:
    """[g] pixel-mean weights of a bilinear resize from g control points to
    n samples: w[v] = mean_i M[i,v], M the n x g resize matrix, computed by
    resizing the identity with `F.interpolate` (half-pixel centres, as
    `jax.image.resize`)."""
    eye = torch.eye(g, dtype=torch.float32)[None]  # [1, g, g]: channels g
    m = F.interpolate(eye, size=n, mode="linear", align_corners=False)[0]  # [g, n]
    return tuple(m.mean(dim=1).numpy().astype(np.float32))


def residual_disp_bound(path, h: int, w: int, method: str) -> torch.Tensor:
    """Upper bound (px) on max_t,p |flow_t(p) - mean_p flow_t| of the dense
    warp flow induced by `path` (tensor or array): the residual the two-pass
    warp must cover, as a 0-dim f32 tensor on the path's device.

    affine [T,2,3]: the flow is affine in (x,y); its pixel mean equals its
    value at the grid center and its extrema sit at the corners.
    grid [T,GH,GW,2]: the dense flow is a separable bilinear upsample, so the
    extrema sit at the vertices and the pixel mean is the vertex-weighted
    average with the `_resize_mean_weights` weights. The time-sharded
    pipeline bounds each rank's slice of the path this way and takes the MAX
    over the ranks; the buckets of `pick_max_disp` absorb a last-bit
    difference between devices."""
    path = torch.as_tensor(path).float()
    if path.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=path.device)
    if method == "affine":
        pts = torch.tensor(
            [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1],
             [(w - 1) / 2.0, (h - 1) / 2.0]],
            dtype=torch.float32, device=path.device,
        )  # 4 corners + center
        lin = einsum_f32("tij,pj->tip", path[:, :, :2], pts) + path[:, :, 2:3]  # [T,2,5]
        fl = lin - pts.T[None]  # flow at the 5 points
        return (fl[:, :, :4] - fl[:, :, 4:5]).abs().amax()
    t, gh, gw, _ = path.shape
    wy = torch.tensor(_resize_mean_weights(gh, h), dtype=torch.float32, device=path.device)
    wx = torch.tensor(_resize_mean_weights(gw, w), dtype=torch.float32, device=path.device)
    mean = einsum_f32("g,q,tgqc->tc", wy, wx, path)
    return (path - mean[:, None, None, :]).abs().amax()


def pick_max_disp(bound, cfg: RenderConfig) -> int:
    """Static kernel bound for a measured residual bound (a float or a 0-dim
    tensor): the smallest bucket covering `bound` (+0.5px mean-rounding
    slack), floored at cfg.max_residual_disp, capped at cfg.max_disp_limit.
    Warns, as the reference does, only when no bucket covers the need."""
    if not cfg.adaptive_max_disp:
        return cfg.max_residual_disp
    bound = float(bound)
    need = max(int(np.ceil(bound + 0.5)), cfg.max_residual_disp)
    limit = min(cfg.max_disp_limit, _DISP_BUCKETS[-1])
    for b in _DISP_BUCKETS:
        if b >= need:
            return min(b, limit)
    log.warning(
        "residual displacement bound %.1fpx exceeds max_disp_limit=%d; "
        "out-of-range pixels will be border-filled", bound, limit,
    )
    return limit


def render_stabilized(
    frames: torch.Tensor, flow: torch.Tensor, cfg: RenderConfig,
    scale: Union[torch.Tensor, float, None] = None, max_disp: Optional[int] = None,
) -> torch.Tensor:
    """Backward-warp frames [T,H,W,C] by flow [T,H,W,2] with crop policy.

    `scale` (a 0-dim tensor or a float) overrides the crop zoom: the blocked
    pipeline needs the 'auto' minimum over all blocks' per-frame scales,
    known only after a first sweep (`auto_crop_scales`). `max_disp` overrides
    cfg.max_residual_disp; callers derive it from the solved path with
    residual_disp_bound / pick_max_disp."""
    t, h, w, c = frames.shape
    d = cfg.max_residual_disp if max_disp is None else max_disp
    with trace.span("vstab.render", device=frames.is_cuda) as s:
        warped = warp_twopass(frames, flow, max_disp=d)
        mask = twopass_validity((h, w), flow, d)[..., None]
        if cfg.crop_mode == "none":
            s.set(zoom_passes=0)
            return warped * mask + cfg.border_value * (1.0 - mask)
        if scale is None:
            scale = fixed_crop_scale(cfg, frames.device)
        if scale is None:
            scale = _auto_scale_per_frame(flow).min()
        scale = torch.as_tensor(scale, dtype=torch.float32, device=frames.device)
        fields = zoom_fields((t, h, w), scale)
        out = zoom_resample(warped, scale, fields)
        maskz = zoom_resample(mask, scale, fields)
        s.set(zoom_passes=4)
        valid = (maskz > 0.999).to(out.dtype)
        return out * valid + cfg.border_value * (1.0 - valid)


def render_affine(frames: torch.Tensor, transforms: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    flow = affine_to_flow(transforms, frames.shape[1], frames.shape[2])
    return render_stabilized(frames, flow, cfg)


def render_grid(frames: torch.Tensor, disp: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    flow = grid_to_flow(disp, frames.shape[1], frames.shape[2])
    return render_stabilized(frames, flow, cfg)


__all__ = [
    "affine_to_flow",
    "auto_crop_scales",
    "fixed_crop_scale",
    "grid_to_flow",
    "pick_max_disp",
    "render_affine",
    "render_grid",
    "render_stabilized",
    "residual_disp_bound",
    "zoom_fields",
    "zoom_resample",
]
