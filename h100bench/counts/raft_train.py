"""RAFT training's operations from its layer shapes, and the bytes and least
time of each launch of the correlation lookup's backward.

A training step of `batch` pairs counts 3 x the forward's operations (the
backward twice the forward), all in float32. The forward of one pair at
h x w (multiples of 8): `fnet` on both frames and `cnet` on the first (three
encoders), the all-pairs correlation (2 C (HW/64)^2), and at each of the
`iters` iterations the update (motion encoder, GRU, flow head) and the mask
head that the convex upsampling takes (`counts/raft.py`'s layer counts).
Norms, activations, poolings, the lookup's arithmetic, the convex
combination and the loss are left out.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from h100bench.counts import HBM_BYTES_PER_S
from h100bench.counts import raft as raft_counts


def forward_ops(h: int, w: int, flow: Mapping) -> float:
    """Operations of one pair's training forward."""
    h8, w8 = raft_counts.grid(h, w)
    px = h8 * w8
    per_iter = raft_counts.update_ops_per_pixel(flow) + raft_counts.mask_ops_per_pixel(flow)
    return 3 * raft_counts.encoder_ops(h, w) + 2.0 * 256 * px * px + flow["iters"] * px * per_iter


def step_ops(batch: int, h: int, w: int, flow: Mapping) -> float:
    """Operations of one training step: 3 x the batch's forward."""
    return 3.0 * batch * forward_ops(h, w, flow)


def lookup_bwd_bytes(args: Sequence) -> float:
    """Bytes of one `vstab_corr_lookup_bwd` launch: per pixel its float32
    gradient row read (levels (2r+1)^2), its coordinates read and each
    level's (2r+2)^2 window written, each once. The zeros of the rest of
    each slice are left out: a lower bound on what any backward of these
    samples has to move.

    Arguments: d0 d1 d2 d3 h0 w0 h1 w1 h2 w2 h3 w3 levels radius coords g npix stream."""
    levels, radius, npix = args[12], args[13], args[16]
    k, side = 2 * radius + 1, 2 * radius + 2
    return npix * (levels * k * k * 4.0 + 8.0 + levels * side * side * 4.0)


def lookup_bwd_bound_s(args: Sequence) -> float:
    """The least time of one backward launch on one H100: its bytes over the HBM rate."""
    return lookup_bwd_bytes(args) / HBM_BYTES_PER_S
