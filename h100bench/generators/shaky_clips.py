"""Shaken clips of a static scene, drawn on the device from the seed.

A torch copy of the repo's synthetic clip (a checker scene twice the frame's
size, seen through a camera with a smoothed random-walk drift, a per-frame
shake and a per-frame roll), so that a run pays no host-side drawing. The
numbers are torch's, not numpy's; the statistics are the same.

Mix parameters (the traffic file): clips, frames, height, width, dtype
("float32" in [0, 1] or "uint8"), place ("device" or "host"), walk_px,
shake_px, shake_angle.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F


def checker_scene(gen: torch.Generator, h: int, w: int) -> torch.Tensor:
    """A detailed static scene [H,W,3] in [0,1]: sinusoids, a ramp and
    block noise at scales 4, 16 and 64."""
    dev = gen.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    img = torch.stack([
        0.5 + 0.5 * torch.sin(xx / 13.0) * torch.cos(yy / 17.0),
        0.5 + 0.5 * torch.cos(xx / 7.0 + yy / 11.0),
        (xx / w + yy / h) / 2.0,
    ], dim=-1)
    for scale in (4, 16, 64):
        small = torch.rand((h // scale + 2, w // scale + 2, 3), generator=gen, device=dev)
        big = small.repeat_interleave(scale, 0).repeat_interleave(scale, 1)[:h, :w]
        img = img + 0.25 * (big - 0.5)
    return img.clamp(0.0, 1.0)


def trajectory(gen: torch.Generator, t: int, walk_px: float, shake_px: float,
               shake_angle: float) -> torch.Tensor:
    """Camera transforms [T,2,3]: drift (a random walk smoothed by a Gaussian
    of sigma 6 frames) plus shake, and a per-frame roll."""
    dev = gen.device
    steps = torch.randn((t, 2), generator=gen, device=dev) * (walk_px * 0.2)
    drift = torch.cumsum(steps, dim=0)
    k = torch.exp(-0.5 * (torch.arange(-15, 16, dtype=torch.float32, device=dev) / 6.0) ** 2)
    k = (k / k.sum()).view(1, 1, -1)
    padded = F.pad(drift.T[:, None, :], (15, 15), mode="replicate")
    drift = F.conv1d(padded, k)[:, 0, :].T
    shake = torch.randn((t, 2), generator=gen, device=dev) * shake_px
    ang = torch.randn((t,), generator=gen, device=dev) * shake_angle
    ca, sa = torch.cos(ang), torch.sin(ang)
    cams = torch.zeros((t, 2, 3), device=dev)
    cams[:, 0, 0], cams[:, 0, 1], cams[:, 1, 0], cams[:, 1, 1] = ca, -sa, sa, ca
    cams[:, :, 2] = drift + shake
    return cams


def render(scene: torch.Tensor, cams: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Frames [T,h,w,3]: pixel p of frame t shows the scene at cams[t] p,
    bilinear, taps clamped to the scene's edge."""
    sh, sw, _ = scene.shape
    dev = scene.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    a = cams[:, None, None]
    sx = a[..., 0, 0] * xx + a[..., 0, 1] * yy + a[..., 0, 2]
    sy = a[..., 1, 0] * xx + a[..., 1, 1] * yy + a[..., 1, 2]
    grid = torch.stack([sx / (sw - 1) * 2 - 1, sy / (sh - 1) * 2 - 1], dim=-1)
    src = scene.permute(2, 0, 1)[None].expand(cams.shape[0], 3, sh, sw)
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def clip(gen: torch.Generator, t: int, h: int, w: int, walk_px: float = 3.0,
         shake_px: float = 6.0, shake_angle: float = 0.01, dtype: str = "float32",
         chunk: int = 16) -> torch.Tensor:
    """One shaken clip [T,H,W,3] on the generator's device: float32 in
    [0,1], or uint8 (rounded), drawn `chunk` frames at a time."""
    my, mx = h // 2, w // 2
    scene = checker_scene(gen, h + 2 * my, w + 2 * mx)
    cams = trajectory(gen, t, walk_px, shake_px, shake_angle)
    cams[:, :, 2] += torch.tensor([float(mx), float(my)], device=gen.device)
    parts = []
    for s in range(0, t, chunk):
        part = render(scene, cams[s : s + chunk], h, w)
        if dtype == "uint8":
            part = torch.clamp(part * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        parts.append(part)
    return torch.cat(parts)


def generate(mix: Mapping, seed: int, device) -> Dict[str, object]:
    """{'clips': the pool, each [T,H,W,3] in the mix's dtype, on the device
    or as a numpy array on the host (the mix's place)}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    clips: List = []
    for _ in range(mix["clips"]):
        c = clip(gen, mix["frames"], mix["height"], mix["width"], mix["walk_px"],
                 mix["shake_px"], mix["shake_angle"], mix["dtype"])
        clips.append(c.cpu().numpy() if mix["place"] == "host" else c)
    return {"clips": clips}
