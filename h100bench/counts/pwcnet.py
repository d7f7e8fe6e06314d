"""PWC-Net's operations, counted from its layer shapes.

A multiply-add counts as two operations. A convolution with a k x k kernel
does 2 Cin Cout k^2 operations per output pixel; a 4x4 stride-2 transposed
convolution does 2 Cin Cout 16 per input pixel; the cost volume does
2 (2r+1)^2 C per pixel of its level. Frames are padded to a multiple of
2**levels, as the network pads them. The bilinear resizes, activations,
concatenations and the smoothing and render stages are left out.
"""

from __future__ import annotations

from typing import Mapping, Tuple

CONTEXT_CHANNELS = (128, 128, 128, 96, 64, 32)


def padded(h: int, w: int, flow: Mapping) -> Tuple[int, int]:
    m = 2 ** len(flow["pyramid_channels"])
    return -(-h // m) * m, -(-w // m) * m


def _conv(cin: int, cout: int, h: int, w: int, k: int = 3) -> float:
    return 2.0 * cin * cout * k * k * h * w


def pyramid_flops(h: int, w: int, flow: Mapping) -> float:
    """Operations of encoding one frame of h x w."""
    hp, wp = padded(h, w, flow)
    total, cin = 0.0, 3
    for lvl, ch in enumerate(flow["pyramid_channels"]):
        ho, wo = hp >> (lvl + 1), wp >> (lvl + 1)
        total += _conv(cin, ch, ho, wo) + 2 * _conv(ch, ch, ho, wo)
        cin = ch
    return total


def _levels(flow: Mapping):
    """Pyramid indices the flow is estimated at, coarsest first."""
    return range(len(flow["pyramid_channels"]) - 1, flow["output_level"] - 2, -1)


def cost_volume_flops(h: int, w: int, flow: Mapping) -> float:
    """Operations of one pair's cost volumes."""
    hp, wp = padded(h, w, flow)
    nd = (2 * flow["search_radius"] + 1) ** 2
    pc = flow["pyramid_channels"]
    return sum(2.0 * nd * pc[i] * (hp >> (i + 1)) * (wp >> (i + 1)) for i in _levels(flow))


def pair_flops(h: int, w: int, flow: Mapping) -> float:
    """Operations of one pair's flow from two encoded frames: cost volumes,
    estimators, up-sampling and the context network."""
    return cost_volume_flops(h, w, flow) + pair_conv_flops(h, w, flow)


def pair_conv_flops(h: int, w: int, flow: Mapping) -> float:
    """Operations of one pair's convolutions: estimators, up-sampling and the
    context network."""
    hp, wp = padded(h, w, flow)
    pc = flow["pyramid_channels"]
    nd = (2 * flow["search_radius"] + 1) ** 2
    total, feat_ch = 0.0, None
    for idx in _levels(flow):
        ho, wo = hp >> (idx + 1), wp >> (idx + 1)
        cin = nd + pc[idx]
        if feat_ch is not None:  # up-sampling from the coarser level
            hi, wi = ho // 2, wo // 2
            total += 2.0 * 16 * hi * wi * (2 * 2 + feat_ch * 2)
            cin += 4
        for ch in flow["estimator_channels"]:
            total += _conv(cin, ch, ho, wo)
            cin += ch
        total += _conv(cin, 2, ho, wo)  # predict_flow
        feat_ch = cin
    lvl = flow["output_level"] - 1
    ho, wo = hp >> (lvl + 1), wp >> (lvl + 1)
    cin = feat_ch + 2
    for ch, _ in zip(CONTEXT_CHANNELS, flow["context_dilations"]):
        total += _conv(cin, ch, ho, wo)
        cin = ch
    return total + _conv(cin, 2, ho, wo)  # predict_res


def clip_flops(t: int, h: int, w: int, flow: Mapping) -> float:
    """Operations a clip of t frames needs: t pyramids, t - 1 pairs."""
    return t * pyramid_flops(h, w, flow) + (t - 1) * pair_flops(h, w, flow)


def train_step_flops(n: int, h: int, w: int, flow: Mapping) -> float:
    """Operations of one training step of n pairs: the forward encodes both
    frames of every pair; backward counted as twice the forward."""
    return 3.0 * n * (2 * pyramid_flops(h, w, flow) + pair_flops(h, w, flow))
