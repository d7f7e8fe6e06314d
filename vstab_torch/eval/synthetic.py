"""Synthetic scenes and shaken clips, a numpy-only copy of
`vstab/eval/synthetic.py`.

The reference draws with OpenCV when it is installed (frame rendering,
scene upsampling, anti-aliased ellipses in `shapes_scene`) and with numpy
otherwise; this copy always takes the numpy paths, so it gives the
reference's scenes and frames wherever OpenCV is absent. In `shapes_scene`
that also fixes the stream of random numbers: the reference draws its
ellipse-or-rectangle coin only when OpenCV is there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def checker_scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A detailed static scene: multi-scale noise + gradients, [H,W,3]."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img[..., 0] = 0.5 + 0.5 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    img[..., 1] = 0.5 + 0.5 * np.cos(xx / 7.0 + yy / 11.0)
    img[..., 2] = (xx / w + yy / h) / 2.0
    for scale in (4, 16, 64):
        small = rng.random((h // scale + 2, w // scale + 2, 3)).astype(np.float32)
        big = np.kron(small, np.ones((scale, scale, 1), np.float32))[:h, :w]
        img += 0.25 * (big - 0.5)
    return np.clip(img, 0.0, 1.0)


def _upsample(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear upsample [gh,gw,3] -> [h,w,3] (corner-aligned)."""
    ys = np.linspace(0, img.shape[0] - 1, h)
    xs = np.linspace(0, img.shape[1] - 1, w)
    y0 = np.clip(ys.astype(int), 0, img.shape[0] - 2)
    x0 = np.clip(xs.astype(int), 0, img.shape[1] - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x0 + 1]
    c = img[y0 + 1][:, x0]
    d = img[y0 + 1][:, x0 + 1]
    return (1 - fy) * ((1 - fx) * a + fx * b) + fy * ((1 - fx) * c + fx * d)


def perlin_scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Multi-octave smooth value noise, approximately 1/f spectra like
    natural images; low-contrast smooth regions make it the hard flow case
    (aperture problem). Held out of training: the cross-distribution EPE
    gate runs on this family."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    amp, total = 1.0, 0.0
    for cells in (3, 6, 12, 24, 48, 96):
        g = rng.random((cells + 1, cells + 1, 3)).astype(np.float32)
        img += amp * _upsample(g, h, w)
        total += amp
        amp *= 0.55
    img /= total
    lo, hi = img.min(), img.max()
    return ((img - lo) / (hi - lo + 1e-6)).astype(np.float32)


def shapes_scene(h: int, w: int, seed: int = 0, n_shapes: int = 24) -> np.ndarray:
    """Piecewise-smooth scene: background gradient + random filled
    rectangles: sharp occlusion-like edges and flat interiors (document or
    cartoon statistics, unlike checker's dense texture)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gdir = rng.normal(size=2)
    gdir /= np.hypot(*gdir) + 1e-6
    base = 0.35 + 0.3 * (gdir[0] * yy / h + gdir[1] * xx / w)
    img = np.stack([base, base * 0.9 + 0.05, base * 1.1 - 0.05], axis=-1)
    img = img.astype(np.float32).copy()
    for _ in range(n_shapes):
        color = rng.random(3).astype(float)
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        ry = int(rng.integers(max(2, h // 32), max(3, h // 4)))
        rx = int(rng.integers(max(2, w // 32), max(3, w // 4)))
        y0, y1 = max(0, cy - ry), min(h, cy + ry)
        x0, x1 = max(0, cx - rx), min(w, cx + rx)
        img[y0:y1, x0:x1] = color
    img += rng.normal(0.0, 0.01, size=img.shape)  # sensor-noise floor
    return np.clip(img, 0.0, 1.0).astype(np.float32)


SCENE_FNS = {
    "checker": checker_scene,
    "perlin": perlin_scene,
    "shapes": shapes_scene,
}


def make_scene(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    try:
        return SCENE_FNS[kind](h, w, seed=seed)
    except KeyError:
        raise ValueError(f"unknown scene kind {kind!r}; have {sorted(SCENE_FNS)}") from None


def jitter_trajectory(
    t: int,
    seed: int = 0,
    walk_px: float = 3.0,
    shake_px: float = 6.0,
    shake_angle: float = 0.01,
) -> np.ndarray:
    """Known camera trajectory [T,2,3]: smooth drift + high-frequency shake."""
    rng = np.random.default_rng(seed)
    drift = np.cumsum(rng.normal(0.0, walk_px * 0.2, size=(t, 2)), axis=0)
    k = np.exp(-0.5 * (np.arange(-15, 16) / 6.0) ** 2)
    k /= k.sum()
    drift = np.stack(
        [np.convolve(np.pad(d, 15, mode="edge"), k, "valid") for d in drift.T],
        axis=1,
    )
    shake = rng.normal(0.0, shake_px, size=(t, 2))
    ang = rng.normal(0.0, shake_angle, size=(t,))
    transforms = np.zeros((t, 2, 3), np.float32)
    ca, sa = np.cos(ang), np.sin(ang)
    transforms[:, 0, 0] = ca
    transforms[:, 0, 1] = -sa
    transforms[:, 1, 0] = sa
    transforms[:, 1, 1] = ca
    transforms[:, :, 2] = drift + shake
    return transforms


def _render_frame(scene: np.ndarray, cam: np.ndarray, h: int, w: int) -> np.ndarray:
    """Render one [h,w,3] frame: pixel p shows scene point cam(p), bilinear
    with edge-clamped taps."""
    sh, sw, _ = scene.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = cam[0, 0] * xx + cam[0, 1] * yy + cam[0, 2]
    sy = cam[1, 0] * xx + cam[1, 1] * yy + cam[1, 2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0 = x0.astype(np.int32)
    y0 = y0.astype(np.int32)

    def tap(yi, xi):
        yi = np.clip(yi, 0, sh - 1)
        xi = np.clip(xi, 0, sw - 1)
        return scene[yi, xi]

    return (
        ((1 - fx) * (1 - fy))[..., None] * tap(y0, x0)
        + (fx * (1 - fy))[..., None] * tap(y0, x0 + 1)
        + ((1 - fx) * fy)[..., None] * tap(y0 + 1, x0)
        + (fx * fy)[..., None] * tap(y0 + 1, x0 + 1)
    )


def make_shaky_clip(
    t: int = 30,
    h: int = 256,
    w: int = 320,
    seed: int = 0,
    scene_kind: str = "checker",
    **jitter_kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (frames [T,H,W,3] f32, true camera transforms [T,2,3]): frame
    t is the scene, twice the frame's size, seen through camera C_t."""
    margin_y, margin_x = h // 2, w // 2
    scene = make_scene(scene_kind, h + 2 * margin_y, w + 2 * margin_x, seed=seed)
    cams = jitter_trajectory(t, seed=seed, **jitter_kw)
    cams_scene = cams.copy()
    cams_scene[:, :, 2] += np.asarray([margin_x, margin_y], np.float32)
    frames = np.stack([_render_frame(scene, cam, h, w) for cam in cams_scene], axis=0)
    return frames.astype(np.float32), cams


# ---------------------------------------------------------------------------
# Dynamic scenes: independently moving foreground occluders + parallax.
# ---------------------------------------------------------------------------


def _occluder_tracks(
    t: int, n_occ: int, h: int, w: int, rng: np.random.Generator, speed_px: float
) -> list:
    """Per-occluder geometry + smooth independent trajectories: each
    occluder is a textured ellipse whose centre follows drift + a sine
    wobble, smooth world motion that a correct stabilizer must not chase."""
    occs = []
    for _ in range(n_occ):
        ry = rng.uniform(h / 9.0, h / 4.5)
        rx = rng.uniform(w / 9.0, w / 4.5)
        cy0 = rng.uniform(ry, h - ry)
        cx0 = rng.uniform(rx, w - rx)
        vel = rng.normal(0.0, speed_px, size=2)
        amp = rng.uniform(0.0, speed_px * 4.0, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        om = rng.uniform(0.05, 0.2, size=2)
        ts = np.arange(t)
        cy = cy0 + vel[0] * ts + amp[0] * np.sin(om[0] * ts + ph[0])
        cx = cx0 + vel[1] * ts + amp[1] * np.sin(om[1] * ts + ph[1])
        # depth in (0,1] scales the camera's effect on the occluder (parallax)
        depth = rng.uniform(0.5, 1.0)
        occs.append({
            "ry": ry, "rx": rx, "cy": cy, "cx": cx, "depth": depth,
            "tex_seed": int(rng.integers(0, 2**31 - 1)),
        })
    return occs


def make_dynamic_clip(
    t: int = 30,
    h: int = 256,
    w: int = 320,
    seed: int = 0,
    scene_kind: str = "checker",
    n_occluders: int = 3,
    occluder_speed_px: float = 1.0,
    **jitter_kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shaky clip with independently moving textured foreground occluders
    and parallax: (frames [T,H,W,3] f32, background camera transforms
    [T,2,3], the trajectory a correct stabilizer follows).

    The background is `make_shaky_clip`'s planar scene under the camera path
    C_t; each occluder is an ellipse of `shapes` texture whose centre follows
    its own smooth world trajectory and is then seen through a depth-scaled
    copy of the camera (near layers shake more)."""
    rng = np.random.default_rng(seed + 991)
    frames, cams = make_shaky_clip(t=t, h=h, w=w, seed=seed, scene_kind=scene_kind, **jitter_kw)
    frames = frames.copy()
    occs = _occluder_tracks(t, n_occluders, h, w, rng, occluder_speed_px)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for occ in occs:
        tex = make_scene("shapes", h, w, seed=occ["tex_seed"])
        for ti in range(t):
            # Screen p shows world C_t(p); the occluder sits at world X_t, so
            # its screen position solves C~_t(p) = X_t, with C~ the camera
            # scaled toward the identity by (1 - depth).
            cam = cams[ti]
            a = np.eye(2) + occ["depth"] * (cam[:, :2] - np.eye(2))
            b = occ["depth"] * cam[:, 2]
            ctr = np.linalg.solve(a, [occ["cx"][ti], occ["cy"][ti]] - b)
            dy = (yy - ctr[1]) / occ["ry"]
            dx = (xx - ctr[0]) / occ["rx"]
            m = (dx * dx + dy * dy) < 1.0
            # the texture rides with the occluder (sampled in its own frame)
            sy = np.clip(yy - ctr[1] + h / 2.0, 0, h - 1).astype(np.int32)
            sx = np.clip(xx - ctr[0] + w / 2.0, 0, w - 1).astype(np.int32)
            frames[ti][m] = tex[sy[m], sx[m]]
    return frames.astype(np.float32), cams


__all__ = [
    "SCENE_FNS",
    "checker_scene",
    "jitter_trajectory",
    "make_dynamic_clip",
    "make_scene",
    "make_shaky_clip",
    "perlin_scene",
    "shapes_scene",
]
