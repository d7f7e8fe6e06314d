"""The trainer's scene pool, drawn on the device from the seed.

Half checker scenes (`shaky_clips.checker_scene`) and half shapes scenes
(a background gradient, 24 rectangles of random colour and size, sensor
noise of 0.01), alternating, as the trainer's default pool is; a torch copy
of the repo's synthetic scenes, so a run pays no host-side drawing.

Mix parameters (the traffic file): scenes, height, width, then the trainer's
batch, max_disp and seed offset of its batch generator (batch_seed_offset).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from h100bench.generators.shaky_clips import checker_scene


def shapes_scenes(gen: torch.Generator, n: int, h: int, w: int, n_shapes: int = 24) -> torch.Tensor:
    """n piecewise-smooth scenes [n,H,W,3] in [0,1]."""
    dev = gen.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    gdir = torch.randn((n, 2), generator=gen, device=dev)
    gdir = gdir / (gdir.norm(dim=1, keepdim=True) + 1e-6)
    base = 0.35 + 0.3 * (gdir[:, 0].view(n, 1, 1) * yy / h + gdir[:, 1].view(n, 1, 1) * xx / w)
    img = torch.stack([base, base * 0.9 + 0.05, base * 1.1 - 0.05], dim=-1)
    for _ in range(n_shapes):
        color = torch.rand((n, 1, 1, 3), generator=gen, device=dev)
        cy = torch.randint(0, h, (n, 1, 1), generator=gen, device=dev)
        cx = torch.randint(0, w, (n, 1, 1), generator=gen, device=dev)
        ry = torch.randint(max(2, h // 32), max(3, h // 4), (n, 1, 1), generator=gen, device=dev)
        rx = torch.randint(max(2, w // 32), max(3, w // 4), (n, 1, 1), generator=gen, device=dev)
        inside = (yy >= cy - ry) & (yy < cy + ry) & (xx >= cx - rx) & (xx < cx + rx)
        img = torch.where(inside[..., None], color, img)
    img = img + 0.01 * torch.randn(img.shape, generator=gen, device=dev)
    return img.clamp(0.0, 1.0)


def generate(mix: Mapping, seed: int, device) -> Dict[str, object]:
    """{'scenes': [S,H,W,3] on the device, 'batch_seed': the seed of the
    trainer's batch generator}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s, h, w = mix["scenes"], mix["height"], mix["width"]
    checker = torch.stack([checker_scene(gen, h, w) for _ in range((s + 1) // 2)])
    shapes = shapes_scenes(gen, s // 2, h, w)
    scenes = torch.empty((s, h, w, 3), device=device)
    scenes[0::2], scenes[1::2] = checker, shapes
    return {"scenes": scenes, "batch_seed": seed + mix["batch_seed_offset"]}
