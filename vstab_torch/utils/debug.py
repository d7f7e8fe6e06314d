"""Checked stabilization for debug runs, the port of `vstab/utils/debug.py`.

The hazards are NaN / Inf out of the f32 solve and displacements that leave
the render's padded image. The reference runs its XLA kernel twins under
`jax.experimental.checkify`, which checks every float op and every gather.
torch has no such instrument, so `stabilize_checked` runs the pipeline's
stages in turn, as the reference's `_clip_flow` then `_smooth_and_render`,
and checks each stage's output where it hands over to the next: the input
frames, the flow, the smoothed path, the residual flow and the rendered
frames must be finite, and the render's residual displacement must lie
within the bucket +-d its 1-D warps run with (a larger one would clamp
their taps: the counterpart of an out-of-bounds gather).

The checks are explicit tensors read on the host, so the stages run as they
do in `stabilize`: on a CUDA device through the hand-written kernels, on the
CPU through their plain versions (the wrappers choose by the tensor's
device, never by a debug switch). Each check waits for the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from vstab_torch.core.config import Config
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.pipeline import (
    Params,
    clip_flow,
    params_on,
    render_bucket,
    render_path,
    resolve_device,
    smooth_paths,
)

# What the port checks in place of checkify's float and index error sets,
# each named in the error it raises.
CHECKS = ("nan", "inf", "residual displacement")


def _finite(stage: str, x: torch.Tensor) -> None:
    counts = (int(torch.isnan(x).sum()), int(torch.isinf(x).sum()))
    bad = ", ".join(f"{n} {kind}" for kind, n in zip(CHECKS, counts) if n)
    if bad:
        raise FloatingPointError(f"stabilize_checked: {bad} values in the {stage}")


@torch.inference_mode()
def _smooth_and_render_checked(
    frames: torch.Tensor, flow: torch.Tensor, cfg: Config
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Smoothing and render of `stabilize` (the bucket of the solved path
    where cfg.render.adaptive_max_disp, else the static bound), checked."""
    _finite("flow", flow)
    hw = tuple(frames.shape[1:3])
    path, diags = smooth_paths(flow, cfg, hw)
    _finite("smoothed path", path)
    bound, d = render_bucket(path, cfg, hw)

    def check(warp_flow: torch.Tensor) -> None:
        _finite("residual flow", warp_flow)
        if bound + 0.5 > d:  # `pick_max_disp`'s slack for the rounded mean shift
            raise IndexError(
                f"stabilize_checked: {CHECKS[2]} up to {bound:.2f} px (+0.5) leaves the render's bucket +-{d} px"
            )

    out = render_path(frames, path, cfg, d, check=check)
    _finite("rendered frames", out)
    return out, diags


@torch.inference_mode()
def stabilize_checked(
    frames, params: Params, cfg: Config = Config(), device=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`pipeline.stabilize`, checked at every stage boundary: raises
    FloatingPointError naming the stage whose output holds NaN or Inf, and
    IndexError where the render's residual displacement exceeds its bucket.
    Runs on CUDA unless `device` says otherwise. Debug runs only: every
    check reads back to the host."""
    dev = resolve_device(device)
    pin_full_f32()
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    _finite("input frames", frames)
    flow = clip_flow(params_on(params, dev), frames, cfg)
    return _smooth_and_render_checked(frames, flow, cfg)


__all__ = ["CHECKS", "stabilize_checked"]
