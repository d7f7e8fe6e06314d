"""PWC-Net's forward pass (Sun et al., CVPR 2018, as the configuration gives
it), written out as plain functions over a state dict.

Channels last ([N,H,W,C]). Convolutions pad as flax's 'SAME' does (a
stride-2 3x3 convolution on an even size pads (0, 1)); the 4x4 stride-2
transposed convolutions take (in, out, kh, kw) kernels already flipped in
space, as `h100bench.weights` gives them. Every layer computes in float32;
under the "fp8" policy the operands of the layers that the configuration
states in bfloat16 (the pyramid, the estimators' dense convolutions, the
feature up-sampling, the context network, the cost volume's features) are
rounded to float8 first, and `predict_flow`, `upflow` and `predict_res`
stay float32, as the configuration states; under "tf32" every
convolution's operands are rounded to TF32.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference import warps
from h100bench.reference.precision import lowp

CONTEXT_CHANNELS = (128, 128, 128, 96, 64, 32)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def _same_pads(size: int, k: int, stride: int, dilation: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv(p: Mapping[str, torch.Tensor], name: str, x: torch.Tensor, policy: str,
         stride: int = 1, dilation: int = 1, low: bool = True) -> torch.Tensor:
    """flax's Conv with 'SAME' padding on [N,H,W,C]."""
    w, b = p[name + ".weight"], p[name + ".bias"]
    k = w.shape[-1]
    ph = _same_pads(x.shape[1], k, stride, dilation)
    pw = _same_pads(x.shape[2], k, stride, dilation)
    cast = lambda t: lowp(policy, t, low)  # noqa: E731
    xc = F.pad(cast(x).permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, cast(w), b.float(), stride=stride, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def conv_transpose(p: Mapping[str, torch.Tensor], name: str, x: torch.Tensor, policy: str,
                   low: bool = True) -> torch.Tensor:
    """4x4, stride 2, 'SAME': [N,H,W,Cin] -> [N,2H,2W,Cout]."""
    cast = lambda t: lowp(policy, t, low)  # noqa: E731
    y = F.conv_transpose2d(
        cast(x).permute(0, 3, 1, 2), cast(p[name + ".weight"]), p[name + ".bias"].float(),
        stride=2, padding=1,
    )
    return y.permute(0, 2, 3, 1)


def pyramid(p, x: torch.Tensor, n_levels: int, policy: str) -> Tuple[torch.Tensor, ...]:
    """Features per level, finest (1/2) first: a stride-2 and two plain 3x3
    convolutions a level, each followed by LeakyReLU(0.1)."""
    feats = []
    for lvl in range(n_levels):
        x = leaky(conv(p, f"pyramid.conv{lvl}a", x, policy, stride=2))
        x = leaky(conv(p, f"pyramid.conv{lvl}b", x, policy))
        x = leaky(conv(p, f"pyramid.conv{lvl}c", x, policy))
        feats.append(x)
    return tuple(feats)


def _estimator(p, idx: int, x: torch.Tensor, n_convs: int, policy: str):
    for i in range(n_convs):
        y = leaky(conv(p, f"estimator{idx}.conv{i}", x, policy))
        x = torch.cat([y, x], dim=-1)
    return conv(p, f"estimator{idx}.predict_flow", x, policy, low=False), x


def _context(p, feat: torch.Tensor, flow: torch.Tensor, dilations: Sequence[int], policy: str):
    x = torch.cat([feat, flow], dim=-1)
    for i, dil in enumerate(dilations[: len(CONTEXT_CHANNELS)]):
        x = leaky(conv(p, f"context.dconv{i}", x, policy, dilation=dil))
    return flow + conv(p, "context.predict_res", x, policy, low=False)


def _feat(policy: str, x: torch.Tensor) -> torch.Tensor:
    """A feature map as the warp and the cost volume take it: float8 under
    "fp8" (the configuration states them in bfloat16), else float32 (no
    matmul, so TF32 does not reach them)."""
    return lowp(policy, x) if policy == "fp8" else x.float()


def flow_pyramid(p, feats1, feats2, cfg: Mapping, policy: str) -> Tuple[torch.Tensor, ...]:
    """Coarse-to-fine flow over the two pyramids: per-level flows, coarsest
    first, each in pixels of its level; the last has the context residual."""
    n_levels = len(cfg["pyramid_channels"])
    flows = []
    flow = feat = None
    for idx in range(n_levels - 1, cfg["output_level"] - 2, -1):
        f1, f2 = feats1[idx], feats2[idx]
        if flow is None:
            f2w, extra = f2, []
        else:
            upflow = 2.0 * conv_transpose(p, f"up{idx}.upflow", flow, policy, low=False)
            upfeat = conv_transpose(p, f"up{idx}.upfeat", feat, policy)
            f2w = warps.bilinear_warp(_feat(policy, f2), upflow, max_disp=cfg["warp_max_disp"])
            extra = [upflow, upfeat]
        cv = leaky(warps.cost_volume(_feat(policy, f1), _feat(policy, f2w), cfg["search_radius"]))
        flow_l, feat = _estimator(
            p, idx, torch.cat([cv, f1] + extra, dim=-1), len(cfg["estimator_channels"]), policy
        )
        flow = flow_l if flow is None else flow_l + upflow
        flows.append(flow)
    flows[-1] = _context(p, feat, flow, cfg["context_dilations"], policy)
    return tuple(flows)


def upsample_flow(flow: torch.Tensor, level: int) -> torch.Tensor:
    """Level flow -> input resolution: bilinear, half-pixel centres, values x 2**level."""
    s = 2**level
    _, h, w, _ = flow.shape
    out = F.interpolate(flow.permute(0, 3, 1, 2), size=(h * s, w * s), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1) * float(s)


def pad_to_multiple(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Edge-pad H and W of [N,H,W,C] up to a multiple of mult."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (-h) % mult, (-w) % mult
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    return x


def unit(frames: torch.Tensor) -> torch.Tensor:
    """Frames as float32 in [0, 1]: uint8 ones scaled by 1/255."""
    return frames.float() / 255.0 if frames.dtype == torch.uint8 else frames.float()


def pair_flow_blocks(p: Dict[str, torch.Tensor], frames: torch.Tensor, cfg: Mapping,
                     policy: str, pairs_per_block: int = 8) -> Iterator[torch.Tensor]:
    """Consecutive-pair flow of a clip [T,H,W,3] (float in [0, 1] or uint8),
    [<=pairs_per_block,H,W,2] a block of pairs at a time so that it fits;
    each frame's pyramid is used by both pairs it belongs to."""
    t, h, w, _ = frames.shape
    n_levels = len(cfg["pyramid_channels"])
    for s in range(0, t - 1, pairs_per_block):
        blk = pad_to_multiple(unit(frames[s : min(t, s + pairs_per_block + 1)]), 2**n_levels)
        feats = pyramid(p, blk, n_levels, policy)
        fl = flow_pyramid(p, [f[:-1] for f in feats], [f[1:] for f in feats], cfg, policy)[-1]
        yield upsample_flow(fl, cfg["output_level"])[:, :h, :w]
