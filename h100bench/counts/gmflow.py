"""GMFlow with refinement's operations by dtype, counted from its layer
shapes, and the least time of its attention and matchings.

A multiply-add counts as two operations; a convolution with a k x k kernel
does 2 Cin Cout k^2 operations per output pixel, a linear layer 2 Cin Cout
per token. Frames are padded to multiples of 32, as GMFlow's InputPadder
pads them: the 1/8 grid of a 720p frame is 92x160 (14,720 tokens), the
1/4 grid 184x320 (58,880). A clip of t frames counts its real pairs only
(t - 1; the program pads its last chunk with repeated frames): t backbones;
per pair and scale the transformer over both frames (6 blocks of a
self-attention layer and a cross-attention layer with FFN: the
projections, the attention products QK and PV within the windows, the FFN),
the matching (the logits, and the softmax's product with the coordinates or
displacements) and the propagation (two projections, the logits, the
product with the flow); the upsampler's two convolutions at 1/4. The
backbone, the transformer and the upsampler run in bfloat16, the matchings
and propagations in float32. Norms, activations, softmaxes, the position
code, the warp, the convex combination and the stabilizer's other stages
are left out.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

from h100bench.counts import PEAK_FLOPS

C = 128
BLOCKS, FFN = 6, 4
# per scale: (scale, windows a side, matching radius, propagation radius); -1 is global
SCALES = ((8, 2, -1, -1), (4, 8, 4, 1))


def grid(h: int, w: int, scale: int) -> Tuple[int, int]:
    """The 1/scale grid of frames of h x w, padded to multiples of 32."""
    return -(-h // 32) * (32 // scale), -(-w // 32) * (32 // scale)


def _conv(cin: int, cout: int, px: int, k: int = 3) -> float:
    return 2.0 * cin * cout * k * k * px


def backbone_ops(h: int, w: int) -> float:
    """The CNN backbone on one frame: 1/2, 1/4, and the trident convolution at 1/4 and 1/8."""
    h4, w4 = grid(h, w, 4)
    h8, w8 = grid(h, w, 8)
    p2, p4, p8 = (2 * h4) * (2 * w4), h4 * w4, h8 * w8
    total = _conv(3, 64, p2, 7)
    total += 4 * _conv(64, 64, p2)  # layer1
    total += _conv(64, 96, p4) + 3 * _conv(96, 96, p4) + _conv(64, 96, p4, 1)  # layer2
    total += _conv(96, 128, p4) + 3 * _conv(128, 128, p4) + _conv(96, 128, p4, 1)  # layer3
    total += _conv(128, C, p4, 1)  # conv2
    return total + _conv(C, C, p4) + _conv(C, C, p8)  # trident, strides 1 and 2


def attention_ops(h: int, w: int, scale: int, splits: int) -> float:
    """QK and PV of one pair's transformer at one scale: 2 layers a block,
    each of the two frames' tokens against the tokens of its window."""
    hs, ws = grid(h, w, scale)
    window = (hs // splits) * (ws // splits)
    return 2 * BLOCKS * 2 * hs * ws * 4.0 * window * C


def transformer_ops(h: int, w: int, scale: int, splits: int) -> float:
    """One pair's transformer at one scale: per token and block, 4 + 4
    projections of C x C and the FFN (2C -> 2C e -> C), and the attention."""
    hs, ws = grid(h, w, scale)
    per_token = BLOCKS * (8 * 2.0 * C * C + 2.0 * 2 * C * 2 * C * FFN + 2.0 * 2 * C * FFN * C)
    return 2 * hs * ws * per_token + attention_ops(h, w, scale, splits)


def match_ops(h: int, w: int, scale: int, radius: int) -> float:
    """One pair's matching: 2 C a candidate for the logit and 4 for the
    softmax's product with the candidate's (x, y)."""
    hs, ws = grid(h, w, scale)
    k = hs * ws if radius < 0 else (2 * radius + 1) ** 2
    return hs * ws * k * (2.0 * C + 4.0)


def propagate_ops(h: int, w: int, scale: int, radius: int) -> float:
    """One pair's propagation: the query's and the key's projections, then as a matching."""
    hs, ws = grid(h, w, scale)
    return hs * ws * 4.0 * C * C + match_ops(h, w, scale, radius)


def upsampler_ops(h: int, w: int) -> float:
    """The upsampler's mask at 1/4: conv3x3 130 -> 256, conv1x1 256 -> 144."""
    h4, w4 = grid(h, w, 4)
    return _conv(2 + C, 256, h4 * w4) + _conv(256, 16 * 9, h4 * w4, 1)


def pair_ops(h: int, w: int) -> Dict[str, float]:
    """One pair's operations from its two encoded frames, by dtype."""
    bf16 = upsampler_ops(h, w)
    f32 = 0.0
    for scale, splits, corr, prop in SCALES:
        bf16 += transformer_ops(h, w, scale, splits)
        f32 += match_ops(h, w, scale, corr) + propagate_ops(h, w, scale, prop)
    return {"bfloat16": bf16, "float32": f32}


def clip_ops(t: int, h: int, w: int) -> Dict[str, float]:
    """Operations of a clip of t frames, by the dtype they run in."""
    pair = pair_ops(h, w)
    return {"bfloat16": t * backbone_ops(h, w) + (t - 1) * pair["bfloat16"],
            "float32": (t - 1) * pair["float32"]}


def least_s(ops: Mapping[str, float]) -> float:
    """Seconds of `ops` at the peaks of their dtypes, one after the other."""
    return sum(n / PEAK_FLOPS[dtype] for dtype, n in ops.items())


def attention_least_s(attn_flops: float, match_flops: float) -> float:
    """The least time of the attention products (bfloat16) and of the
    matchings and propagations (float32), as the program's spans count
    them: `attn_flops` and `match_flops` (with `prop_flops`)."""
    return attn_flops / PEAK_FLOPS["bfloat16"] + match_flops / PEAK_FLOPS["float32"]
