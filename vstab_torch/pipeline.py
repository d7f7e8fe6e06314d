"""Whole-clip stabilization, the port of `vstab/pipeline.py`.

`stabilize(frames, params, cfg)` runs flow -> smoothing (sparse-LS grid or
global affine) -> render on one clip, `stabilize_batch` on a batch of clips
with one render bucket for the batch. They run on the CUDA device unless the
caller passes `device="cpu"`; with no CUDA device they raise rather than
falling back to the CPU. On CUDA the four
hand-written kernels carry the flow and render stages; on the CPU their
plain torch versions do.

`params` is the port's state dict of the flow network (`default_params`):
PWC-Net's for a `FlowConfig`, RAFT's (`vstab_torch.flow.raft`) for a
`RaftConfig`, GMFlow's (`vstab_torch.flow.gmflow`) for a `GmflowConfig` in
`cfg.flow`.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from vstab_torch.core.config import Config, FlowConfig, GmflowConfig, RaftConfig
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.flow import gmflow, pwcnet, raft
from vstab_torch.flow.pwcnet import PWCNet, estimate_flow_pairs
from vstab_torch.core.types import Clip
from vstab_torch.render.render import pick_max_disp, render_stabilized
from vstab_torch.smooth.stages import pair_motion, residual_bound, solve_path, warp_field
from vstab_torch.utils import trace
from vstab_torch.utils.checkpoint import latest_checkpoint, load_params, params_from_jax

log = logging.getLogger("vstab_torch.pipeline")

Params = Mapping[str, torch.Tensor]


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """`device`, or CUDA when it is None. Raises if CUDA is asked for and
    there is none: the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vstab_torch runs on CUDA unless told otherwise, and no CUDA device "
            "is available; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def params_on(params: Params, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The state dict `params` with every tensor on `dev`."""
    return {k: v.to(dev) for k, v in params.items()}


def default_pair_chunk(h: int, w: int) -> int:
    """Frame pairs in one chunk of `clip_flow` for frames of h x w: 8, halved
    per doubling of the frame area above 2.2 megapixels (floor 1), as in the
    reference (2 at 2160x3840)."""
    mp = h * w / 1e6
    return 8 if mp <= 2.2 else max(1, int(8 * 2.1 / mp))


@torch.inference_mode()
def clip_flow(
    params: Params, frames: torch.Tensor, cfg: Config, pair_chunk: Optional[int] = None
) -> torch.Tensor:
    """Consecutive-pair flow over a clip in chunks of `pair_chunk` pairs:
    [T,H,W,3] -> [T-1,H,W,2], by the network that cfg.flow configures, its
    parameters laid out once a call by the network's `prepare`.
    pair_chunk defaults to `default_pair_chunk`, for RAFT lowered until a
    chunk's correlation pyramids fit (`raft.pair_chunk`), for GMFlow until
    its global-matching logits fit (`gmflow.pair_chunk`). The `vstab.flow`
    span carries `aligned_pad`, the zero channels of PWC-Net's layout."""
    t, h, w, _ = frames.shape
    if pair_chunk is None:
        pair_chunk = default_pair_chunk(h, w)
    if isinstance(cfg.flow, (RaftConfig, GmflowConfig)):
        net = raft if isinstance(cfg.flow, RaftConfig) else gmflow
        pair_chunk = net.pair_chunk(h, w, cfg.flow, pair_chunk)
        params, flow_pairs = net.prepare(params, cfg.flow), net.estimate_flow_pairs
        aligned = 0
    else:
        params, flow_pairs = pwcnet.prepare(params, cfg.flow), estimate_flow_pairs
        aligned = pwcnet.aligned_pad(params, cfg.flow)
    n_pairs = t - 1
    n_chunks = -(-n_pairs // pair_chunk)
    pad = n_chunks * pair_chunk + 1 - t
    with trace.span("vstab.flow", device=frames.is_cuda, aligned_pad=aligned):
        if pad:  # repeat the last frame: zero flow for the padded pairs
            frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])], dim=0)
        flows = []
        for i in range(n_chunks):
            with trace.span("vstab.flow.chunk"):
                flows.append(flow_pairs(
                    params, frames[i * pair_chunk : (i + 1) * pair_chunk + 1], cfg.flow
                ))
        return torch.cat(flows, dim=0)[:n_pairs]


@torch.inference_mode()
def smooth_paths(flow: torch.Tensor, cfg: Config, hw: Tuple[int, int]):
    """Flow -> (compact per-frame path, diagnostics): stabilizing affine
    warps [T,2,3] or grid displacements [T,GH,GW,2], by the smoothing method."""
    with trace.span("vstab.smooth", device=flow.is_cuda):
        return solve_path(pair_motion(flow, cfg.smooth), cfg.smooth)


@torch.inference_mode()
def path_to_flow(path: torch.Tensor, cfg: Config, hw: Tuple[int, int]) -> torch.Tensor:
    """Per-frame path -> dense backward-warp flow [T,H,W,2]."""
    with trace.span("vstab.warp_field", device=path.is_cuda):
        return warp_field(path, cfg.smooth, hw)


def render_bucket(path, cfg: Config, hw: Tuple[int, int]) -> Tuple[float, int]:
    """(residual bound in px, render bucket) of a solved per-frame path
    (tensor or array [T,...]): the one place where the adaptive bound of the
    render warps is derived. The bound is computed where the path lies and
    one scalar is read back to the host: the clip's one wait for the card."""
    with trace.span("vstab.bucket", device=torch.is_tensor(path) and path.is_cuda) as s:
        bound = float(residual_bound(path, cfg.smooth, hw))
        d = pick_max_disp(bound, cfg.render)
        s.set(bound_px=bound, max_disp=d)
    return bound, d


@torch.inference_mode()
def render_path(
    frames: torch.Tensor, path: torch.Tensor, cfg: Config, max_disp: Optional[int] = None,
    check: Optional[Callable[[torch.Tensor], None]] = None,
) -> torch.Tensor:
    """Render a clip [T,H,W,3] by its solved path: the bucket of the path
    (with cfg.render.adaptive_max_disp, unless given as `max_disp`), its
    warp field, which `check` sees where given, then `render_stabilized`."""
    hw = tuple(frames.shape[1:3])
    if max_disp is None and cfg.render.adaptive_max_disp:
        _, max_disp = render_bucket(path, cfg, hw)
    flow = path_to_flow(path, cfg, hw)
    if check is not None:
        check(flow)
    return render_stabilized(frames, flow, cfg.render, max_disp=max_disp)


@torch.inference_mode()
def smooth_and_render(
    frames: torch.Tensor, flow: torch.Tensor, cfg: Config
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Smoothing + render with the static bound cfg.render.max_residual_disp."""
    pin_full_f32()
    path, diags = smooth_paths(flow, cfg, tuple(frames.shape[1:3]))
    return render_path(frames, path, cfg, cfg.render.max_residual_disp), diags


@torch.inference_mode()
def stabilize(
    frames, params: Params, cfg: Config = Config(), device=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full pipeline on one clip: [T,H,W,3] -> (stabilized [T,H,W,3], diags).

    With cfg.render.adaptive_max_disp (default) the render warp's bound is
    the bucket `pick_max_disp` derives from the solved path."""
    dev = resolve_device(device)
    pin_full_f32()
    with trace.span("vstab.stabilize") as s:
        frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        t, h, w, _ = frames.shape
        s.set(t=t, h=h, w=w)
        params = params_on(params, dev)
        return stabilize_from_flow(frames, clip_flow(params, frames, cfg), cfg)


@torch.inference_mode()
def stabilize_from_flow(
    frames: torch.Tensor, flow: torch.Tensor, cfg: Config = Config()
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`stabilize` after its clip flow: smoothing + render of frames
    [T,H,W,3] given their pair flow [T-1,H,W,2]. The flow depends only on
    cfg.flow, so runs that differ in smoothing or render can share it."""
    pin_full_f32()
    path, diags = smooth_paths(flow, cfg, tuple(frames.shape[1:3]))
    return render_path(frames, path, cfg), diags


def stabilize_clip(clip: Clip, params: Params, cfg: Config = Config(), device=None) -> Clip:
    out, _ = stabilize(clip.frames, params, cfg, device=device)
    return Clip(frames=out, fps=clip.fps)


@torch.inference_mode()
def stabilize_batch(
    frames, params: Params, cfg: Config = Config(), device=None
) -> torch.Tensor:
    """Stabilize a batch of same-shape clips: [B,T,H,W,3] -> [B,T,H,W,3].

    Flow and solve run clip by clip; with cfg.render.adaptive_max_disp the
    render bucket is picked once, from the largest residual bound over the
    batch, and every clip is rendered with it (otherwise with the static
    cfg.render.max_residual_disp). The 'auto' crop scale stays per clip."""
    dev = resolve_device(device)
    pin_full_f32()
    with trace.span("vstab.stabilize_batch") as s:
        frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        b, t, h, w, _ = frames.shape
        s.set(b=b, t=t, h=h, w=w)
        params = params_on(params, dev)
        paths = torch.stack(
            [smooth_paths(clip_flow(params, fr, cfg), cfg, (h, w))[0] for fr in frames]
        )
        flat = paths.flatten(0, 1)
        max_disp = render_bucket(flat, cfg, (h, w))[1] if cfg.render.adaptive_max_disp else None
        out = torch.empty_like(frames)
        for i in range(b):
            out[i] = render_path(frames[i], paths[i], cfg, max_disp)
        return out


def _params_match(params: Params, flow_cfg: FlowConfig) -> bool:
    """True iff `params` has exactly the names and shapes of
    `PWCNet(flow_cfg)`'s parameters (checked on the meta device: no memory,
    no compute)."""
    want = PWCNet(flow_cfg, device="meta").state_dict()
    return set(params) == set(want) and all(
        tuple(params[k].shape) == tuple(v.shape) for k, v in want.items()
    )


def default_params(
    cfg: Config, seed: Optional[int] = None, ckpt_dir: str = "ckpts", device=None
) -> Dict[str, torch.Tensor]:
    """Flow-net state dict on `device` (CUDA by default): the newest
    checkpoint of ckpt_dir if it fits cfg.flow, else a fresh init from the
    seed (torch's generator: not the JAX package's numbers). RAFT and GMFlow
    have no checkpoint in the repository: their state dicts are drawn from
    the seed."""
    dev = resolve_device(device)
    if isinstance(cfg.flow, RaftConfig):
        return raft.init_params(cfg.seed if seed is None else seed, cfg.flow, dev)
    if isinstance(cfg.flow, GmflowConfig):
        return gmflow.init_params(cfg.seed if seed is None else seed, dev)
    ckpt = latest_checkpoint(ckpt_dir)
    if ckpt is not None:
        params = params_from_jax(load_params(ckpt))
        if _params_match(params, cfg.flow):
            return params_on(params, dev)
        log.warning(
            "checkpoint %s does not match the configured flow architecture; "
            "using fresh init", ckpt,
        )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed if seed is None else seed)
        net = PWCNet(cfg.flow)
    return params_on({k: v.detach() for k, v in net.state_dict().items()}, dev)


__all__ = [
    "clip_flow",
    "default_pair_chunk",
    "default_params",
    "params_on",
    "path_to_flow",
    "render_bucket",
    "render_path",
    "resolve_device",
    "smooth_and_render",
    "smooth_paths",
    "stabilize",
    "stabilize_batch",
    "stabilize_clip",
    "stabilize_from_flow",
]
