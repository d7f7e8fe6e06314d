"""RAFT's operations by dtype, counted from its layer shapes, and the bytes
and least time of each launch of the correlation lookup.

A multiply-add counts as two operations; a convolution with a kh x kw
kernel does 2 Cin Cout kh kw operations per output pixel. Frames are padded
to multiples of 8, as RAFT's InputPadder pads them. A clip of t frames
counts its real pairs only (t - 1; the program pads its last chunk with
repeated frames): t fnet encodings, t - 1 cnet encodings, t - 1 correlations
(2 C (HW/64)^2, float32), t - 1 x iters updates and t - 1 mask heads, all
but the correlation in bfloat16. Norms, activations, poolings, the lookup's
arithmetic, the convex combination and the stabilizer's other stages are
left out.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from h100bench.counts import HBM_BYTES_PER_S, PEAK_FLOPS


def _conv(cin: int, cout: int, px: int, kh: int = 3, kw: int = None) -> float:
    return 2.0 * cin * cout * kh * (kh if kw is None else kw) * px


def grid(h: int, w: int) -> Tuple[int, int]:
    """The 1/8-resolution grid of frames of h x w."""
    return -(-h // 8), -(-w // 8)


def encoder_ops(h: int, w: int, out_dim: int = 256) -> float:
    """One BasicEncoder on one frame."""
    h8, w8 = grid(h, w)
    p2, p4, p8 = (4 * h8) * (4 * w8), (2 * h8) * (2 * w8), h8 * w8
    total = _conv(3, 64, p2, 7)
    total += 4 * _conv(64, 64, p2)  # layer1
    total += _conv(64, 96, p4) + 3 * _conv(96, 96, p4) + _conv(64, 96, p4, 1)  # layer2
    total += _conv(96, 128, p8) + 3 * _conv(128, 128, p8) + _conv(96, 128, p8, 1)  # layer3
    return total + _conv(128, out_dim, p8, 1)


def update_ops_per_pixel(flow: Mapping) -> float:
    """One update step (motion encoder, GRU, flow head) at one pixel of the grid."""
    cor_planes = flow["corr_levels"] * (2 * flow["corr_radius"] + 1) ** 2
    hid = flow["hidden"]
    gru_in = hid + 128 + hid
    return (_conv(cor_planes, 256, 1, 1) + _conv(256, 192, 1) + _conv(2, 128, 1, 7)
            + _conv(128, 64, 1) + _conv(256, 126, 1)
            + 6 * _conv(gru_in, hid, 1, 1, 5)
            + _conv(hid, 256, 1) + _conv(256, 2, 1))


def mask_ops_per_pixel(flow: Mapping) -> float:
    return _conv(flow["hidden"], 256, 1) + _conv(256, 576, 1, 1)


def clip_ops(t: int, h: int, w: int, flow: Mapping) -> Dict[str, float]:
    """Operations of a clip of t frames, by the dtype they run in."""
    h8, w8 = grid(h, w)
    px, pairs = h8 * w8, t - 1
    bf16 = (t * encoder_ops(h, w) + pairs * encoder_ops(h, w)
            + pairs * px * (flow["iters"] * update_ops_per_pixel(flow) + mask_ops_per_pixel(flow)))
    f32 = pairs * 2.0 * 256 * px * px
    return {"bfloat16": bf16, "float32": f32}


def least_s(ops: Mapping[str, float]) -> float:
    """Seconds of `ops` at the peaks of their dtypes, one after the other."""
    return sum(n / PEAK_FLOPS[dtype] for dtype, n in ops.items())


def _window_entries(n: int, size: int, radius: int, lvl: int) -> np.ndarray:
    """Per position of an n-long axis of the grid: the entries of the
    level's `size`-long axis inside the 2r+2 window at the position's own
    place (zero flow)."""
    lo = np.floor(np.arange(n) / 2**lvl).astype(np.int64) - radius
    return np.clip(lo + 2 * radius + 2, 0, size) - np.clip(lo, 0, size)


def lookup_bytes(args: Sequence) -> float:
    """Bytes of one `vstab_corr_lookup` launch: per pixel and level, the
    float32 entries of the level inside the (2r+2)^2 window around the
    pixel's own position at zero flow, plus its coordinates read and its
    levels (2r+1)^2 outputs written, each once. A lower bound on what any
    lookup at these coordinates has to move.

    Arguments: l0 l1 l2 l3 h0 w0 h1 w1 h2 w2 h3 w3 levels radius coords out npix dtype stream."""
    sizes = args[4:12]
    levels, radius, npix, dtype = args[12], args[13], args[16], args[17]
    h0, w0 = sizes[0], sizes[1]
    images = npix // (h0 * w0)
    entries = 0
    for lvl in range(levels):
        hl, wl = sizes[2 * lvl], sizes[2 * lvl + 1]
        rows = _window_entries(h0, hl, radius, lvl)
        cols = _window_entries(w0, wl, radius, lvl)
        entries += int(rows.sum()) * int(cols.sum())
    out_size = 2 if dtype == 1 else 4
    return images * entries * 4.0 + npix * (8.0 + levels * (2 * radius + 1) ** 2 * out_size)


def lookup_bound_s(args: Sequence) -> float:
    """The least time of one lookup launch on one H100: its bytes over the HBM rate."""
    return lookup_bytes(args) / HBM_BYTES_PER_S
