"""The smoothing method, `cfg.smooth.method`: the one module that reads it.
Every path (whole clip, batch, blocked, sharded, checked) runs the stages
that depend on it through these functions: `pair_motion` (pair flow ->
vertex motion or pair affines), `solve_path` (the motion of a clip's pairs
-> per-frame path), `warp_field` and `residual_bound` (of that path). A
time-sharded solve passes a `Shard`, which brings the collectives.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vstab_torch.core.config import SmoothConfig
from vstab_torch.render.render import affine_to_flow, grid_to_flow, residual_disp_bound
from vstab_torch.smooth.affine import (
    chain_path,
    fit_affine_from_flow,
    smooth_path,
    stabilizing_transforms,
)
from vstab_torch.smooth.sparse_ls import smooth_profiles, temporal_diagonals, vertex_motion


class Shard(NamedTuple):
    """A rank's part of a time-sharded solve: its `rows` of the clip padded
    to `t_pad` frames. `gather(x)` concatenates every rank's x in rank order,
    `offset(x)` sums the x of the ranks before, `solve(d0, d1, d2, rhs)`
    solves the band systems across the ranks."""

    rows: slice
    t_pad: int
    gather: Callable
    offset: Callable
    solve: Callable


def _affine(sc: SmoothConfig) -> bool:
    if sc.method not in ("affine", "sparse_ls"):
        raise ValueError(f"unknown smoothing method {sc.method!r} (expected 'affine' or 'sparse_ls')")
    return sc.method == "affine"


def pair_motion(flow: torch.Tensor, sc: SmoothConfig) -> torch.Tensor:
    """Pair flow [N,H,W,2] -> vertex motion [N,GH,GW,2] or pair affines [N,2,3]."""
    if _affine(sc):
        return fit_affine_from_flow(flow)
    return vertex_motion(flow, sc.grid_size, sc.robust_iters)


def solve_path(
    motion: torch.Tensor, sc: SmoothConfig, shard: Optional[Shard] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`pair_motion` of a clip's pairs -> (per-frame stabilizing path,
    diags): the displacement grid C - P [T,GH,GW,2] with diags {"profiles":
    C, "smoothed": P}, or the warps [T,2,3] with diags {"warps", "path",
    "smoothed"}. With `shard`: the rank's rows, from the motion of its pairs
    (the last reaching into the next rank); the affine path gathers every
    rank's pair affines (24 bytes a frame) and solves the whole path."""
    if _affine(sc):
        if shard is not None:
            motion = shard.gather(motion)[: shard.t_pad - 1]
        path = chain_path(motion)
        sm = smooth_path(path, sigma=sc.affine_sigma)
        warps = stabilizing_transforms(path, sm)
        diags = {"warps": warps, "path": path.transforms, "smoothed": sm.transforms}
        return (warps if shard is None else warps[shard.rows]), diags
    if shard is None:
        c = torch.cat([torch.zeros_like(motion[:1]), torch.cumsum(motion, dim=0)], dim=0)
        p = smooth_profiles(c, sc)
    else:  # the rank's profiles: its exclusive cumsum plus the ranks before
        cum = torch.cumsum(motion, dim=0)
        offset = shard.offset(cum[-1])
        c = torch.cat([torch.zeros_like(motion[:1]), cum[:-1]], dim=0) + offset[None]
        # the rank's rows of the global bands, in the length-T convention
        bands = tuple(np.pad(x, (0, shard.t_pad - len(x)))[shard.rows]
                      for x in temporal_diagonals(shard.t_pad, sc.lambda_smooth, sc.lambda_accel))
        p = smooth_profiles(c, sc, bands=bands, solve=shard.solve)
    return c - p, {"profiles": c, "smoothed": p}


def warp_field(path: torch.Tensor, sc: SmoothConfig, hw: Tuple[int, int]) -> torch.Tensor:
    """Per-frame path -> dense backward-warp flow [T,H,W,2]."""
    return affine_to_flow(path, *hw) if _affine(sc) else grid_to_flow(path, *hw)


def residual_bound(path, sc: SmoothConfig, hw: Tuple[int, int]) -> torch.Tensor:
    """`residual_disp_bound` of a per-frame path (tensor or array)."""
    return residual_disp_bound(path, hw[0], hw[1], sc.method)


__all__ = ["Shard", "pair_motion", "residual_bound", "solve_path", "warp_field"]
