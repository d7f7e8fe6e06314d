"""The time-sharded stabilization pipeline, the port of
`vstab/dist/pipeline_dist.py`.

A clip's frames are split over the ranks of a time group, each rank holding
a contiguous slice on its own device. Every stage is local to a rank except

  1. flow at the slice's end  -> a 1-frame halo from the next rank
     (`extend_right`);
  2. the vertex-profile cumsum -> the exclusive prefix of the per-rank totals
     (one all_gather);
  3. the smoothing solve      -> the distributed Schur solve (sparse-LS), or
     an all_gather of the per-pair affines and the chain and low-pass on
     every rank (affine);
  4. the render bucket        -> a MAX all-reduce of the per-rank residual
     bounds, and the bucket picked on the host from that scalar;
  5. the 'auto' crop scale    -> a MIN all-reduce of the per-frame scales of
     the real (not padded) frames.

Device memory per rank is O(T / n_time). The two stages are those of the
reference: stage 1 (flow and solve) gives the per-frame path of the rank's
frames and the global residual bound; stage 2 renders the rank's frames with
the bucket that bound picks, as the single-device pipelines do.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from vstab_torch.core.config import Config
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.dist.halo import all_gather_cat, exclusive_prefix_sum, extend_right
from vstab_torch.dist.mesh import Mesh, make_mesh, time_size, time_slice
from vstab_torch.dist.schur_dist import schur_solve_shard
from vstab_torch.pipeline import clip_flow, params_on, resolve_device
from vstab_torch.render.render import auto_crop_scales, pick_max_disp, render_stabilized
from vstab_torch.smooth.stages import Shard, pair_motion, residual_bound, solve_path, warp_field


def _local_frames(frames, rows: slice, t: int, dev: torch.device) -> torch.Tensor:
    """This rank's frames of the clip padded with freeze frames. Only its
    real frames go to the device (the clip's last one, for a rank that has
    none); the rows past the clip's end repeat that frame there."""
    lo = min(rows.start, t - 1)
    hi = max(min(rows.stop, t), lo + 1)
    local = torch.as_tensor(frames[lo:hi], dtype=torch.float32, device=dev)
    pad = rows.stop - rows.start - local.shape[0]
    if pad:
        local = torch.cat([local, local[-1:].expand(pad, *local.shape[1:])], dim=0)
    return local


@torch.inference_mode()
def stabilize_sharded(
    frames, params, cfg: Config, mesh: Optional[Mesh] = None, device=None, gather: bool = False
) -> Tuple[torch.Tensor, Dict]:
    """Time-parallel stabilize over the time group of `mesh`: [T,H,W,3] ->
    (out, diags). Every rank of the group calls it with the whole clip on its
    host (numpy or tensor) and uploads only its own frames. With a process
    group up, `mesh` is required (`make_mesh(cfg.dist)`, a collective call
    that creates process groups: build it once); with none, the default is
    the world of one.

    T is padded with freeze frames to a multiple of n_time * block_len; a
    rank holds t_loc = T_pad / n_time of them. `out` is this rank's rows of
    the output, the global frames [start, min(start + t_loc, T)), with
    `diags["start"]`; with `gather=True` it is the whole [T,H,W,3] on every
    rank (start 0). diags also holds t_pad, t_loc, n_time, the global
    residual bound and the render bucket (`max_disp`).

    Runs on CUDA unless `device="cpu"`; the collectives take the backend
    of the tensors' device (gloo for the CPU, NCCL for CUDA)."""
    if mesh is None:
        if dist.is_initialized():
            raise ValueError(
                "stabilize_sharded: pass mesh=make_mesh(cfg.dist), built once; with a "
                "process group up, make_mesh creates process groups on every call"
            )
        mesh = make_mesh(cfg.dist)
    dev = resolve_device(device)
    pin_full_f32()
    group = mesh.time_group
    n_t = time_size(mesh)
    bl = cfg.smooth.block_len
    t, h, w = frames.shape[:3]
    t_pad = -(-t // (n_t * bl)) * (n_t * bl)
    rows = time_slice(t_pad, mesh)
    t_loc = rows.stop - rows.start
    params = params_on(params, dev)

    # Stage 1: flow over this rank's frames and the next rank's first one
    # (the last rank repeats its last frame: a freeze pair),
    # then the distributed solve.
    local = _local_frames(frames, rows, t, dev)
    flow = clip_flow(params, extend_right(local, 1, group), cfg)  # [T_loc, H, W, 2]
    shard = Shard(
        rows, t_pad, gather=functools.partial(all_gather_cat, group=group),
        offset=functools.partial(exclusive_prefix_sum, group=group),
        solve=functools.partial(schur_solve_shard, block_len=bl, group=group),
    )
    path, _ = solve_path(pair_motion(flow, cfg.smooth), cfg.smooth, shard)
    del flow

    # The render bucket from the residual bound of the whole padded path:
    # a MAX over the ranks, and one scalar read back to the host.
    bound = residual_bound(path, cfg.smooth, (h, w))
    if dist.is_initialized():
        dist.all_reduce(bound, op=dist.ReduceOp.MAX, group=group)
    bound = float(bound)
    max_disp = pick_max_disp(bound, cfg.render)

    # Stage 2: render this rank's frames. 'auto' crops every frame by the
    # smallest per-frame scale over the real frames of the clip.
    warp_flow = warp_field(path, cfg.smooth, (h, w))
    scale = None
    per_frame = auto_crop_scales([warp_flow], cfg.render)
    if per_frame is not None:
        gidx = torch.arange(rows.start, rows.stop, device=dev)
        scale = torch.where(gidx < t, next(per_frame), 1.0).amin()
        if dist.is_initialized():
            dist.all_reduce(scale, op=dist.ReduceOp.MIN, group=group)
    out = render_stabilized(local, warp_flow, cfg.render, scale=scale, max_disp=max_disp)
    del local, warp_flow

    diags = {
        "t_pad": t_pad, "t_loc": t_loc, "n_time": n_t, "residual_bound_px": bound,
        "max_disp": max_disp, "crop_scale": None if scale is None else float(scale),
    }
    if gather:
        return all_gather_cat(out, group)[:t], {**diags, "start": 0}
    return out[: max(0, min(rows.stop, t) - rows.start)], {**diags, "start": rows.start}


__all__ = ["stabilize_sharded"]
