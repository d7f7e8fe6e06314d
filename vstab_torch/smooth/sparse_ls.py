"""Sparse-least-squares motion-field smoothing, the port of
`vstab/smooth/sparse_ls.py`.

A GH x GW grid of vertices accumulates the local flow into vertex profiles
C_t(g). Smoothed profiles P minimize

  E(P) = lam_d  sum_t ||P_t - C_t||^2                      (data)
       + lam_s  sum_t ||P_{t+1} - P_t||^2                  (temporal smooth)
       + lam_a  sum_t ||P_{t+1} - 2 P_t + P_{t-1}||^2      (acceleration)
       + lam_r  sum_t ||D_s (P_t - C_t)||^2                (spatial rigidity)

In the eigenbasis of the spatial grid Laplacian the normal equations
decouple into G x 2 independent SPD pentadiagonal systems in time, solved by
the banded loop below 3*block_len frames and by the Schur block solver from
there on. Every f32 matrix product runs with TF32 off.

The host-side numpy builders (`_pool_matrices`, `spatial_modes`,
`temporal_diagonals`) are copies of the reference's.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vstab_torch.core.config import SmoothConfig
from vstab_torch.core.precision import einsum_f32
from vstab_torch.smooth.banded import banded_solve_scan
from vstab_torch.smooth.schur import schur_solve


@functools.lru_cache(maxsize=16)
def _pool_matrices(h: int, w: int, gh: int, gw: int):
    """Row-normalized 0/1 cell-selector matrices (By [GH,H], Bx [GW,W]) for
    averaging over the linspace partition of rows/cols (host-side, static)."""

    def sel(n, g):
        edges = np.linspace(0, n, g + 1).astype(np.int64)
        m = np.zeros((g, n), np.float32)
        for i in range(g):
            m[i, edges[i] : edges[i + 1]] = 1.0 / max(edges[i + 1] - edges[i], 1)
        return m

    return sel(h, gh), sel(w, gw)


def _pool(by: torch.Tensor, bx: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """Separable cell pooling: [N,H,W,C] -> [N,GH,GW,C]."""
    return einsum_f32("xw,ngwc->ngxc", bx, einsum_f32("gh,nhwc->ngwc", by, field))


def _spread(byb: torch.Tensor, bxb: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Broadcast a cell value back to its pixels: [N,GH,GW,C] -> [N,H,W,C]."""
    return einsum_f32("hg,ngwc->nhwc", byb.T, einsum_f32("wx,ngxc->ngwc", bxb.T, cell))


def vertex_motion(
    flow: torch.Tensor, grid_size: Tuple[int, int], robust_iters: int = 2
) -> torch.Tensor:
    """Per-vertex motion from dense flow: [N,H,W,2] -> [N,GH,GW,2], by IRLS
    (Geman-McClure) weighted cell pooling with a per-cell scale of 1.5 times
    the mean absolute residual plus 0.25. robust_iters=0 is the plain mean."""
    n, h, w, _ = flow.shape
    gh, gw = grid_size
    by_np, bx_np = _pool_matrices(h, w, gh, gw)
    dev = flow.device
    by = torch.from_numpy(by_np).to(dev)
    bx = torch.from_numpy(bx_np).to(dev)
    byb = torch.from_numpy((by_np > 0).astype(np.float32)).to(dev)
    bxb = torch.from_numpy((bx_np > 0).astype(np.float32)).to(dev)
    est = _pool(by, bx, flow)
    for _ in range(max(0, robust_iters)):
        r2 = ((flow - _spread(byb, bxb, est)) ** 2).sum(dim=-1, keepdim=True)
        c_cell = 1.5 * _pool(by, bx, torch.sqrt(r2)) + 0.25
        c_pix = _spread(byb, bxb, c_cell)
        wgt = c_pix**2 / (c_pix**2 + r2)  # Geman-McClure
        est = _pool(by, bx, wgt * flow) / torch.clamp(_pool(by, bx, wgt), min=1e-6)
    return est


def vertex_profiles(
    flow: torch.Tensor, grid_size: Tuple[int, int], robust_iters: int = 2
) -> torch.Tensor:
    """Accumulated vertex paths C: [T-1,H,W,2] flow -> [T,GH,GW,2]."""
    m = vertex_motion(flow, grid_size, robust_iters)
    return torch.cat([torch.zeros_like(m[:1]), torch.cumsum(m, dim=0)], dim=0)


@functools.lru_cache(maxsize=8)
def spatial_modes(gh: int, gw: int) -> Tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition of the 4-neighbor grid Laplacian: (V [G,G], mu [G])."""
    g = gh * gw
    lap = np.zeros((g, g), np.float64)
    idx = lambda i, j: i * gw + j
    for i in range(gh):
        for j in range(gw):
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ni, nj = i + di, j + dj
                if 0 <= ni < gh and 0 <= nj < gw:
                    lap[idx(i, j), idx(i, j)] += 1.0
                    lap[idx(i, j), idx(ni, nj)] -= 1.0
    mu, v = np.linalg.eigh(lap)
    return v.astype(np.float32), np.maximum(mu, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def temporal_diagonals(t: int, lam_s: float, lam_a: float):
    """Band diagonals of lam_s*D1^T D1 + lam_a*D2^T D2 (numpy, static T)."""
    d0 = np.zeros(t, np.float32)
    d1 = np.zeros(max(t - 1, 0), np.float32)
    d2 = np.zeros(max(t - 2, 0), np.float32)
    if t >= 2:
        d0[: t - 1] += lam_s
        d0[1:] += lam_s
        d1 += -lam_s
    if t >= 3:
        for r in range(1, t - 1):
            d0[r - 1] += lam_a
            d0[r] += 4.0 * lam_a
            d0[r + 1] += lam_a
            d1[r - 1] += -2.0 * lam_a
            d1[r] += -2.0 * lam_a
            d2[r - 1] += lam_a
    return d0, d1, d2


def smooth_profiles(
    c: torch.Tensor,
    cfg: SmoothConfig,
    bands: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    solve: Optional[Callable] = None,
) -> torch.Tensor:
    """Solve for smoothed vertex profiles P given C [T,GH,GW,2].

    `bands` are the temporal band diagonals (d0, d1, d2) of c's rows
    (default: `temporal_diagonals(T)`) and `solve(d0, d1, d2, rhs)` solves
    the decoupled [T, G*2] band systems (default: the banded loop below
    3*block_len frames, the Schur block solver from there on); the
    time-sharded pipeline passes its rows of the global bands and the
    distributed Schur solve."""
    t, gh, gw, _ = c.shape
    g = gh * gw
    dev = c.device
    v_np, mu_np = spatial_modes(gh, gw)
    v = torch.from_numpy(v_np).to(dev)
    mu = torch.from_numpy(mu_np).to(dev)
    if bands is None:
        bands = temporal_diagonals(t, cfg.lambda_smooth, cfg.lambda_accel)
    td0, td1, td2 = (torch.from_numpy(x).to(dev) for x in bands)
    alpha = cfg.lambda_data + cfg.lambda_rigid * mu  # [G]
    ctil = einsum_f32("ig,tic->tgc", v, c.reshape(t, g, 2))  # to eigenbasis
    rhs = (alpha[None, :, None] * ctil).reshape(t, g * 2)

    m = g * 2
    d0 = (td0[:, None] + alpha.repeat_interleave(2)[None, :]).expand(t, m)
    d0 = d0 + cfg.damping
    d1 = td1[:, None].expand(td1.shape[0], m)
    d2 = td2[:, None].expand(td2.shape[0], m)

    if solve is not None:
        ptil = solve(d0, d1, d2, rhs)
    elif t >= 3 * cfg.block_len:
        ptil = schur_solve(d0, d1, d2, rhs, block_len=cfg.block_len)
    else:
        ptil = banded_solve_scan(d0, d1, d2, rhs)
    p = einsum_f32("ig,tgc->tic", v, ptil.reshape(t, g, 2))  # back: V @ ptil
    return p.reshape(t, gh, gw, 2)


def smooth_grid_field(
    flow: torch.Tensor, frame_hw: Tuple[int, int], cfg: SmoothConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow [T-1,H,W,2] -> (stabilizing displacement grid [T,GH,GW,2], diags).

    The renderer samples input frame t at p + interp(disp_t)(p); disp = C - P
    (real camera path minus smoothed path)."""
    c = vertex_profiles(flow, cfg.grid_size, cfg.robust_iters)
    p = smooth_profiles(c, cfg)
    return c - p, {"profiles": c, "smoothed": p}


__all__ = [
    "smooth_grid_field",
    "smooth_profiles",
    "spatial_modes",
    "temporal_diagonals",
    "vertex_motion",
    "vertex_profiles",
]
