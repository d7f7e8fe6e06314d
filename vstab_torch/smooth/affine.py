"""Global-affine camera-path smoothing, the port of `vstab/smooth/affine.py`.

Stages:
1. `fit_affine_from_flow`: robust IRLS least-squares fit of a 2x3 affine to
   each inter-frame flow field (Huber weights, batched 3x3 normal equations).
2. `chain_path`: accumulate the pairwise transforms into the camera
   trajectory C_t (frame 0 -> frame t) by log-step doubling.
3. `smooth_path`: Gaussian low-pass of the trajectory parameters.
4. `stabilizing_transforms`: W_t = C_t o S_t^{-1}, which maps output
   (stabilized) pixel coordinates to input-frame coordinates for the
   renderer's backward warp.

Every f32 matrix product runs with TF32 off (`core/precision.py`): the normal
equations hold sums of squared pixel coordinates, which ten mantissa bits
cannot carry.
"""

from __future__ import annotations

import numpy as np
import torch

from vstab_torch.core.precision import einsum_f32
from vstab_torch.core.types import (
    CameraPath,
    compose_affine,
    identity_affine,
    invert_affine,
)


def _grid_points(h: int, w: int, step: int, device):
    ys = torch.arange(step // 2, h, step, dtype=torch.float32, device=device)
    xs = torch.arange(step // 2, w, step, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return xx.reshape(-1), yy.reshape(-1)


def fit_affine_from_flow(flow: torch.Tensor, step: int = 16, iters: int = 3) -> torch.Tensor:
    """Fit 2x3 affines A_t with p + flow_t(p) ~ A_t p. flow: [N,H,W,2] -> [N,2,3].

    IRLS with Huber weights on a grid of sample points every `step` pixels;
    the scale is 1.345 times the median residual, the median being the mean
    of the two middle values where the point count is even."""
    n, h, w, _ = flow.shape
    xs, ys = _grid_points(h, w, step, flow.device)
    xi = xs.long()
    yi = ys.long()
    u = flow[:, yi, xi, 0].float()  # [N, P]
    v = flow[:, yi, xi, 1].float()
    t_xy = torch.stack([xs[None] + u, ys[None] + v], dim=-1)  # [N, P, 2] target coords

    # Design matrix for [a, b, tx; c, d, ty]: X = [x, y, 1] per point.
    X = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # [P, 3]
    eye = 1e-6 * torch.eye(3, dtype=torch.float32, device=flow.device)
    wgt = torch.ones_like(u)
    sol = None
    for _ in range(iters):
        # Weighted normal equations, solved once for both output rows.
        XtW = X.T[None] * wgt[:, None, :]  # [N, 3, P]
        A = einsum_f32("nip,pj->nij", XtW, X) + eye
        b = einsum_f32("nip,npk->nik", XtW, t_xy)  # [N, 3, 2]
        # solve_ex: the same LU as linalg.solve without its error check,
        # which would make the host wait for the device at every iteration
        # (A is positive definite: weights > 0 and the 1e-6 ridge).
        sol = torch.linalg.solve_ex(A, b).result
        r = torch.sqrt(((einsum_f32("pi,nik->npk", X, sol) - t_xy) ** 2).sum(dim=-1) + 1e-8)
        delta = 1.345 * torch.clamp(torch.quantile(r, 0.5, dim=-1, keepdim=True), min=1e-3)
        wgt = torch.clamp(delta / r, max=1.0)  # Huber weights
    return sol.transpose(1, 2)  # [N, 2, 3]


def chain_path(pair_transforms: torch.Tensor) -> CameraPath:
    """Accumulate pairwise A_t (frame t -> t+1 coords) into C_t (frame 0 -> t):
    C_0 = I, C_{t+1} = A_t o C_t, as an inclusive scan by doubling (about
    log2 T batched compositions): out[t] = seq[t] o ... o seq[0]."""
    eye = identity_affine(pair_transforms.dtype, pair_transforms.device)[None]
    out = torch.cat([eye, pair_transforms], dim=0)  # [T, 2, 3]
    s = 1
    while s < out.shape[0]:
        # out[t] holds seq[t] o ... o seq[t-s+1]; the earlier half goes first.
        out = torch.cat([out[:s], compose_affine(out[s:], out[:-s])], dim=0)
        s *= 2
    return CameraPath(transforms=out)


def smooth_path(path: CameraPath, sigma: float = 9.0) -> CameraPath:
    """Gaussian low-pass of the 6 affine parameters along time, reflect
    padded. The pad (3 sigma frames) may be longer than the clip: the indices
    then reflect repeatedly, as `numpy.pad(mode="reflect")` does."""
    tr = path.transforms
    t = tr.shape[0]
    radius = max(1, int(3 * sigma))
    k = torch.arange(-radius, radius + 1, dtype=torch.float32, device=tr.device)
    kern = torch.exp(-0.5 * (k / sigma) ** 2)
    kern = kern / kern.sum()
    idx = torch.from_numpy(np.pad(np.arange(t), radius, mode="reflect")).to(tr.device)
    padded = tr.reshape(t, 6).index_select(0, idx)  # [T+2r, 6]
    # The kernel is symmetric, so correlation and convolution are the same.
    smoothed = (padded.unfold(0, 2 * radius + 1, 1) * kern).sum(dim=-1)  # [T, 6]
    return CameraPath(transforms=smoothed.reshape(t, 2, 3))


def stabilizing_transforms(orig: CameraPath, smoothed: CameraPath) -> torch.Tensor:
    """W_t = C_t o S_t^{-1}: output-pixel -> input-frame coords. [T,2,3]."""
    return compose_affine(orig.transforms, invert_affine(smoothed.transforms))


def smooth_affine(flow: torch.Tensor, sigma: float = 9.0) -> torch.Tensor:
    """flow [T-1,H,W,2] -> per-frame stabilizing affine warps [T,2,3]."""
    path = chain_path(fit_affine_from_flow(flow))
    return stabilizing_transforms(path, smooth_path(path, sigma=sigma))


__all__ = [
    "fit_affine_from_flow",
    "chain_path",
    "smooth_path",
    "stabilizing_transforms",
    "smooth_affine",
]
