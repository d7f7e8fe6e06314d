#!/usr/bin/env python3
"""Drive the vstab_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, `nvcc`
and the repository's `ckpts/`. It does the following (step 4 runs after
step 15, once every path has shown its shapes, dtypes and buckets; step 12
after it):

1. prints the card (`nvidia-smi` name and power limit) and the torch and
   CUDA versions; exits non-zero when torch sees no CUDA device;
2. builds the hand-written kernels (four forward, two backward) from `vstab_torch/kernels/csrc/`
   (one `nvcc` per source, in parallel) and prints the build time;
3. runs the main path: `default_params` reads `ckpts/flow_086000.msgpack`
   with the port's own reader, then `stabilize` runs on the 48x720x1280
   synthetic clip (`make_shaky_clip(t=48, h=720, w=1280, seed=0)`, the input
   of `bench.py`) with bf16 flow. Launch counters are zeroed just before and
   read just after; every kernel must have launched. A second, timed run
   gives frames/s; a third gives the flow / smooth / render times; a fourth
   runs under torch.profiler for device time by kernel;
4. holds each forward kernel against its plain torch version on the card, at
   the shapes the main path gives it (the cost volume at its five pyramid levels
   in bf16 and two f32 shapes, the middle and the finest level of
   compute_dtype="float32"; the feature warp at the four levels it runs
   on, plus one f32 shape for its vector kernel and one 3-channel shape for
   its element kernel; the render warps at the bucket the main path chose,
   `hwarp` with 1 and 3 channels and at a width whose rows are not 16-byte
   aligned, `vwarp` on a per-pixel random field and on a smooth field of the
   main path's kind), and times kernel, plain version and (for the warps)
   `F.grid_sample` as a yardstick, with CUDA events; then prints, for each
   kernel, the sum over its shapes of launches x ms beside the device time
   the profiler gave it in the run;
5. checks the output: finite, [48,720,1280,3], and on a small f32 clip the
   card's output agrees with the CPU run of the plain versions (which the
   CPU tests hold against the JAX package);
6. checks the Schur branch of the smoothing solve (T=128) against the
   banded solve on the card;
7. affine: `stabilize` with `smooth.method="affine"` on the same clip (finite,
   right shape, all four kernels launched, the bucket printed), and the small
   clip's card-against-CPU check for that method;
8. batch: `stabilize_batch` on the clip and its time reverse, each output
   against `stabilize` on that clip with the batch's bucket;
9. blocked, 720p: the clip played forward then backward (95 frames, quantized
   to uint8 levels) through `stabilize_blocked` with `block_len=32`, from
   float32 and from uint8 frames, both against `stabilize` on the card (same
   `max_disp`, 99.9% of the pixels within 2e-3), with the stats, frames/s,
   peak device memory of the blocked and the whole-clip run, the profiler's
   device idle share of a blocked run, and the frames/s of warm blocked runs
   with the pipeline's fetch on a second stream against a plain `.cpu()`;
10. blocked, 1080p: a 33-frame 1920x1080 clip with `block_len=16` the same
   way: the kernels' first run at the 1080p pyramid shapes (1080 rows padded
   to 1088) and the 1920-wide render. Step 4 holds every kernel against its
   plain version at the shapes of steps 7 to 10 too (the affine path's bucket,
   the batch's, the two block lengths), and holds each path's launch counts
   to its chunks of frame pairs and its render dispatches. The trainer's
   path (step 13) and the eval sweep's (step 15) are held the same way: the
   cost volume and the feature warp in f32 at the five and four level shapes
   of a batch of 8 at 192x256, the batch maker's unclipped 3-channel f32 warp
   of the frames (8x192x256x3, displacements to +-30) and the photometric
   loss's (8x48x64x3); the sweep's bf16 levels at 256x320 and its 48-frame
   render dispatches at each clip's bucket, with 5 and 4 launches a chunk of
   pairs and the render warps' launches a dispatch. Then the peak device
   memory of one 64-frame 1080p uint8 render dispatch;
11. file to file, where the machine has OpenCV (`cv2`; read once at the start
   and printed): writes a short 720p file and runs `python -m vstab_torch
   stabilize ... --blocked --block-len 16` as a subprocess, then checks its
   record and the output's frame count. Without `cv2` it says that this step
   was not run.

12. backward kernels: the gradients of the cost volume and of the feature
   warp (`KERNELS_BWD`), each against its plain backward version and against
   autograd of the plain forward, at the trainer's level shapes (batch 8 at
   192x256) in f32 and bf16 and at the 720p level in bf16, plus odd channel
   counts, a smaller radius, flow off every edge, and the clipped-flow case
   (zero flow gradient where the forward clipped); timed beside the plain
   version and, for the warp, `F.grid_sample`'s backward; the photometric
   loss's flow-only warp gradient; at the finest trainer level both kernels'
   gradients of an image alone equal to the bit to the batch of 8's, and the
   warp's equal to the bit in two calls, one kernel and nothing else in a
   CUDA-graph capture of a call, and the wrapper's host time a call;
13. train: the default `FlowConfig` in f32 from `init_params(0)`, batch 8 at
   192x256, 64 scenes: on the first batch every parameter's gradient through
   the kernels against the same loss with the plain versions swapped in on
   the card, in the supervised and in the photometric mode; then 40 steps of `train_fast` with every launch counted (5 cost
   volumes and 4 + 4 warps a step forward, 5 and 4 backward), finite metrics
   at every chunk, the last 10 steps' mean loss below the first 10's, and a
   falling loss over ten more steps on one fixed batch; five photometric
   steps on that pair (one more warp a step forward and backward: 5 + 5);
   ms a step split into batch, forward,
   backward and optimizer, peak memory, the profiler's device time of the two
   backward kernels in a step; 10 steps in bf16 from the same init; 20 steps
   warm-started from `flow_086000` with `eval_epe` before and after;
14. checkpoint round trip: the file `train_fast` saved, read back with the
   port's reader, gives the same flow on a fixed pair, to 0;
15. eval: `run_sweep` on three synthetic 48x256x320 clips (two planar, one
   with moving occluders) with `flow_086000`: three records with scores in
   [0, 1]; a second call resumes without stabilizing anything; then the same
   through `python -m vstab_torch eval`. Needs `cv2` and raises without it.

16. sharded (runs after step 8): a one-rank NCCL process group, and
   `vstab_torch.dist.stabilize_sharded` on the main clip from host frames
   (T=48 padded to 64 with freeze frames, `block_len` 32) with the sparse-LS
   and the affine smoothing, each against `stabilize` on the clip padded the
   same way (same bucket, 99.9% of the values within 2e-3); frames/s beside
   `stabilize`'s on the 48 and on the 64 frames, peak memory, the NCCL
   version, a profiled run. Step 4 holds the kernels at its shapes (8 chunks
   of pairs, one 64-frame render dispatch).

Every path of steps 3, 7 to 10, 15 and 16 is driven with the launch counters
zeroed just before and read just after, and must have launched all four
forward kernels; step 13 does the same for the two kernels inside the network
and their backward kernels.

Before its last line it prints `{"kernels": [...]}`, one entry per kernel;
its last line is `{"ok": true, "device": {...}}`. Any failed check raises,
and the script then exits non-zero without that line.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# Device memory rate by card name (NVIDIA data sheets), bytes/s.
_HBM_RATE = (
    ("H100 PCIe", 2.0e12),
    ("H100 NVL", 3.9e12),
    ("H200", 4.8e12),
    ("H100", 3.35e12),  # H100 SXM, 80 GB HBM3
)
_F32_RATE = 67e12  # H100 SXM f32 outside the tensor cores, flop/s
_BF16_RATE = 989e12  # H100 SXM dense bf16 on the tensor cores, flop/s

_MAIN = "whole_720p"  # the path whose launches the `kernels` line reports
_LEVEL_CHANNELS = (32, 64, 96, 128, 196)  # pyramid levels 2..6 of the default Config


def _level_shapes(h: int, w: int, pairs: int = 8):
    """Shapes the flow network gives the cost volume for frames of h x w: a
    chunk of `pairs` frame pairs, the frame padded to a multiple of 64, the
    pyramid levels it estimates at (1/4 to 1/64), finest first. The feature
    warp runs at every level but the coarsest."""
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    return tuple((pairs, hp >> l, wp >> l, c) for l, c in zip(range(2, 7), _LEVEL_CHANNELS))


# compute_dtype="float32" on the whole clip: the middle level and the finest
_CV_F32_SHAPES = ((8, 48, 80, 96), (8, 192, 320, 32))
# Substring of each kernel's device functions in the profiler's names.
_DEVICE_NAMES = {
    "cost_volume": "cost_volume_", "bilinear_warp": "bilinear_warp_",
    "vwarp": "vwarp_", "hwarp": "hwarp_",
}

# Tolerances of kernel vs plain version on the card. bf16 outputs: both sum
# in f32 and round once to bf16, so they may differ by one bf16 ulp
# (relative 2^-7). f32 outputs: the same taps and weights, rounding apart.
_TOL = {torch.bfloat16: (2.0**-7, 1e-5), torch.float32: (0.0, 1e-5)}


def _say(*parts) -> None:
    print(*parts, flush=True)


def _hbm_rate(name: str) -> float:
    for key, rate in _HBM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of `iters` single-call times, CUDA events. The device first
    spins for a fraction of a millisecond, so that the call is queued behind
    it and the events enclose the device's time for the call, not the host's
    time to issue it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _check(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    rtol, atol = _TOL[want.dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = int((err > atol + rtol * w.abs()).sum())
    max_err = float(err.max())
    _say(f"  check {name}: shape {tuple(got.shape)} {got.dtype} max_abs_err {max_err:.3e} "
         f"(tol {atol:g} + {rtol:g}*|plain|) -> {'ok' if bad == 0 else f'{bad} elements out'}")
    if got.shape != want.shape or bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_err


def _grid(h, w, u, v, dtype):
    """Normalized grid_sample grid for sampling at (x+u, y+v), align_corners=True."""
    ys = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    gx = (xs + u) / (w - 1) * 2 - 1
    gy = (ys + v) / (h - 1) * 2 - 1
    return torch.stack(torch.broadcast_tensors(gx, gy), dim=-1).to(dtype).contiguous()


def _bound(row: dict, hbm: float) -> None:
    """bound_ms: the larger of bytes / memory rate and operations / peak rate
    of their type (row["rate"]), from this run's shapes."""
    t_bytes = row["bytes"] / hbm * 1e3
    t_ops = (row["flops"] or 0) / row.pop("rate", _F32_RATE) * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(hbm: float, paths: dict):
    """Checks and times every forward kernel at the shapes and dtypes of
    every path in `paths`: name -> {"hw" of the frames, "chunks" of frame
    pairs the flow network ran on, "launches" of one run; where they are not
    the serving paths' 8 and bf16, "pairs" a chunk and the "dtype" of the
    network's features; for a path that renders, "n" frames a dispatch and
    "renders", {bucket: dispatches}; for the trainer, "image_warps", {shape:
    launches} of the 3-channel unclipped f32 warps outside the network, and
    "also_check", shapes of that warp which another run of the path gives it}.
    Holds each path's launch counts to these. Returns (rows, per_shape,
    floor_ms): the one row per kernel of the `{"kernels": ...}` line, timed at
    the kernel's largest shape on the whole-clip path, every (kernel, shape,
    path) row with its launches a run, and the time this timing gives a
    near-empty launch."""
    from vstab_torch.kernels import (
        bilinear_warp, bilinear_warp_plain, cost_volume, cost_volume_plain,
        hwarp, hwarp_plain, vwarp, vwarp_plain,
    )
    from vstab_torch.kernels.warp import UNBOUNDED

    g = torch.Generator(device="cuda").manual_seed(0)
    per_shape, rows = [], {}
    tiny = torch.zeros((1, 2, 8, 8), device="cuda", dtype=torch.bfloat16)
    floor_ms = _time_ms(lambda: cost_volume(tiny, tiny, 4))
    _say(f"  launch floor: {floor_ms:.4f} ms "
         "(cost_volume on 1x2x8x8 bf16, timed like every kernel: no kernel's time can be below it)")

    def per_level(path, kernel, levels):
        """Launches of a flow kernel at each of its levels: one a chunk of pairs."""
        n, chunks = paths[path]["launches"][kernel], paths[path]["chunks"]
        if kernel == "bilinear_warp":
            n -= sum(paths[path].get("image_warps", {}).values())
        if n != levels * chunks:
            raise AssertionError(
                f"{path}: {kernel} launched {n} times, not once a level ({levels}) for each of {chunks} chunks")
        return chunks

    # -- cost volume, r=4: at the five levels of a chunk of pairs in the
    # path's dtype (bf16: tensor cores, useful operations 2*81*C a pixel; f32,
    # the trainer's: CUDA cores) and, for the whole-clip path, the middle and
    # the finest level of the clip in f32 (compute_dtype="float32"), 0 launches.
    # The forward pass launches it once a level for every chunk of pairs.
    # Every path gets its own rows, also where its frame size is one already
    # shown: its launches belong to its shapes.
    def cv_rows(path, f32_too):
        path_dtype = paths[path].get("dtype", torch.bfloat16)
        shapes = _level_shapes(*paths[path]["hw"], pairs=paths[path].get("pairs", 8))
        count = per_level(path, "cost_volume", len(shapes))
        cases = [(s, path_dtype, count) for s in shapes] + [(s, torch.float32, 0) for s in _CV_F32_SHAPES if f32_too]
        for shape, dtype, launches in cases:
            f1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
            f2 = torch.randn(shape, generator=g, device="cuda").to(dtype)
            n, h, w, c = shape
            size = f1.element_size()
            bf16 = dtype == torch.bfloat16
            per_shape.append(dict(
                kernel="cost_volume", path=path, shape=list(shape) + [str(dtype).split(".")[1], "r=4"],
                launches=launches,
                max_abs_err=_check(f"cost_volume {shape} {dtype}", cost_volume(f1, f2, 4), cost_volume_plain(f1, f2, 4)),
                ms=_time_ms(lambda: cost_volume(f1, f2, 4)),
                plain_ms=_time_ms(lambda: cost_volume_plain(f1, f2, 4), iters=5),
                bytes=(2 * f1.numel() + n * h * w * 81) * size, flops=n * h * w * 81 * c * 2,
                rate=_BF16_RATE if bf16 else _F32_RATE, library_ms=None,
            ))
            del f1, f2

    # -- feature warp: the forward pass warps f2 at every level but the
    # coarsest, once a level for every chunk of pairs, so its launches are
    # four shapes the same number of times each. Image and flow in the path's
    # dtype (bf16, or the trainer's f32), the flow up to +-12 px so that the
    # kernel's +-8 clip matters; the plain version gets the clipped flow. All
    # four go to the vector kernel.
    def warp_rows(path):
        dtype = paths[path].get("dtype", torch.bfloat16)
        shapes = _level_shapes(*paths[path]["hw"], pairs=paths[path].get("pairs", 8))[:4]
        count = per_level(path, "bilinear_warp", len(shapes))
        for shape in shapes:
            warp_row(path, shape, dtype, 12.0, 8, count)

    def warp_row(path, shape, dtype, amp, max_disp, count):
        n, h, w, c = shape
        # features are unit normals, images (3 channels) lie in [0, 1)
        img = (torch.rand if c == 3 else torch.randn)(shape, generator=g, device="cuda").to(dtype)
        flow = ((torch.rand((n, h, w, 2), generator=g, device="cuda") * 2 - 1) * amp).to(dtype)
        clipped = flow.clamp(-max_disp, max_disp)
        img_nchw = img.permute(0, 3, 1, 2)
        grid = _grid(h, w, clipped[..., 0].float(), clipped[..., 1].float(), dtype)
        name = _dt(dtype)
        per_shape.append(dict(
            kernel="bilinear_warp", path=path,
            shape=list(shape) + [name, f"{name} flow to +-{amp:g}" + (", unclipped" if max_disp == UNBOUNDED else "")],
            launches=count,
            max_abs_err=_check(f"bilinear_warp {shape} {name}", bilinear_warp(img, flow, max_disp), bilinear_warp_plain(img, clipped)),
            ms=_time_ms(lambda: bilinear_warp(img, flow, max_disp)),
            plain_ms=_time_ms(lambda: bilinear_warp_plain(img, clipped)),
            bytes=(2 * img.numel() + flow.numel()) * img.element_size(), flops=None,
            library_ms=_time_ms(lambda: F.grid_sample(
                img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)),
        ))

    # -- the trainer's warps outside the network: the batch maker warps the
    # frames (and its occluders' textures) by the ground-truth flow, 3
    # channels in f32, unclipped (the kernel under `UNBOUNDED`; C = 3 takes
    # the element kernel), with displacements well past the +-8 of the
    # feature warp. The photometric loss warps the second image at the finest
    # estimated level the same way: its shape is checked, not timed.
    def image_warp_rows(path):
        for shape, count in paths[path].get("image_warps", {}).items():
            warp_row(path, shape, torch.float32, 30.0, UNBOUNDED, count)
        for shape in paths[path].get("also_check", ()):
            img = torch.rand(shape, generator=g, device="cuda")
            flow = (torch.rand(shape[:3] + (2,), generator=g, device="cuda") * 2 - 1) * 12.0
            err = _check(f"bilinear_warp {shape} float32, unclipped", bilinear_warp(img, flow, UNBOUNDED), bilinear_warp_plain(img, flow))
            per_shape[-1]["max_abs_err"] = max(per_shape[-1]["max_abs_err"], err)

    def extra_warp_checks():
        # Checked, not timed: the vector kernel in f32 (C=8: two vectors a pixel,
        # the runtime count) and the element kernel (C=3).
        for shape, dtype in (((2, 48, 80, 8), torch.float32), ((2, 48, 80, 3), torch.bfloat16)):
            img = torch.randn(shape, generator=g, device="cuda").to(dtype)
            flow = (torch.rand(shape[:3] + (2,), generator=g, device="cuda") * 24 - 12).to(dtype)
            err = _check(f"bilinear_warp {shape} {dtype}", bilinear_warp(img, flow, 8), bilinear_warp_plain(img, flow.clamp(-8, 8)))
            per_shape[-1]["max_abs_err"] = max(per_shape[-1]["max_abs_err"], err)

    # -- 1D render warps, f32, at the padded render width W + 2(d+1). Two
    # kinds of field: "random" draws every pixel in +-1.2 d, so neighbouring
    # pixels tap unrelated rows; "smooth" is what the pipeline gives the warps,
    # a 12x16 grid of vertices a frame (drawn in +-d) upsampled to the frame as
    # grid_to_flow upsamples the solved path. hwarp stages its row whole and
    # takes the same time on both; vwarp gathers from device memory, so its
    # pipeline row is the smooth one and the random one launches 0 times.
    def field(shape, d, kind="random"):
        if kind == "random":
            return (torch.rand(shape, generator=g, device="cuda") * 2.4 * d - 1.2 * d).contiguous()
        coarse = (torch.rand((shape[0], 1, 12, 16), generator=g, device="cuda") * 2 - 1) * d
        return F.interpolate(coarse, size=shape[1:], mode="bilinear", align_corners=False)[:, 0].contiguous()

    # A render dispatch of n frames launches vwarp and hwarp once on the
    # frame, hwarp the other times on a field (`warp_twopass`: twice up to the
    # bucket 63, three times above): four rows a path and bucket (the random
    # vwarp row only on the whole-clip path), each checked in both modes on
    # the field it is timed on.
    def render_rows(path):
        renders, launches = paths[path].get("renders", {}), paths[path]["launches"]
        on_fields = {d: 2 if d <= 63 else 3 for d in renders}
        want = (sum(renders.values()), sum(k * (1 + on_fields[d]) for d, k in renders.items()))
        if (launches["vwarp"], launches["hwarp"]) != want:
            raise AssertionError(
                f"{path}: render dispatches by bucket {renders} launched vwarp {launches['vwarp']} and "
                f"hwarp {launches['hwarp']} times, not {want[0]} and {want[1]}")
        for d, dispatches in renders.items():
            render_rows_at(path, d, dispatches, dispatches * on_fields[d])

    def render_rows_at(path, d, dispatches, on_field):
        n, (h, w) = paths[path]["n"], paths[path]["hw"]
        errs = {"vwarp": [], "hwarp": []}
        if path == _MAIN:
            # The buckets 16, 63 and 127 and the path's own, with 3 channels
            # (the frame) and 1 (the fields that hwarp resamples). At d=16 the
            # rows of 1314 floats do not start 16-byte aligned, so hwarp's
            # 4-byte head and tail copies run.
            for dd, c in sorted({(dd, c) for dd in (16, 63, 127, d) for c in (1, 3)}):
                shape = (n, h, w + 2 * (dd + 1), c)
                x = torch.rand(shape, generator=g, device="cuda")
                f = field(shape[:3], dd)
                for mode in ("edge", "wrap"):
                    errs["vwarp"].append(_check(f"vwarp {shape} d={dd} {mode}", vwarp(x, f, dd, mode), vwarp_plain(x, f, dd, mode)))
                    errs["hwarp"].append(_check(f"hwarp {shape} d={dd} {mode}", hwarp(x, f, dd, mode), hwarp_plain(x, f, dd, mode)))
                del x, f
        cases = [
            ("vwarp", vwarp, vwarp_plain, "wrap", 3, "smooth", dispatches),
            ("vwarp", vwarp, vwarp_plain, "wrap", 3, "random", 0),
            ("hwarp", hwarp, hwarp_plain, "edge", 3, "random", dispatches),
            ("hwarp", hwarp, hwarp_plain, "edge", 1, "random", on_field),
        ]
        for name, kern, plain, mode, c, kind, count in cases:
            if kind == "random" and name == "vwarp" and path != _MAIN:
                continue
            shape = (n, h, w + 2 * (d + 1), c)
            x = torch.rand(shape, generator=g, device="cuda")
            f = field(shape[:3], d, kind)
            if kind == "smooth" or path != _MAIN:
                for m in ("edge", "wrap"):
                    errs[name].append(_check(f"{name} {shape} d={d} {m} {kind} field", kern(x, f, d, m), plain(x, f, d, m)))
            fc = f.clamp(-d, d)
            zero = torch.zeros_like(fc)
            u, v = (zero, fc) if name == "vwarp" else (fc, zero)
            x_nchw = x.permute(0, 3, 1, 2)
            grid = _grid(*shape[1:3], u, v, torch.float32)
            row = dict(
                kernel=name, path=path, shape=list(shape) + [f"d={d} {mode}"], field=kind, launches=count,
                max_abs_err=max(errs[name]),
                ms=_time_ms(lambda: kern(x, f, d, mode)),
                plain_ms=_time_ms(lambda: plain(x, f, d, mode), iters=5),
                bytes=4 * (2 * x.numel() + f.numel()), flops=None,
                # border padding: grid_sample has no wrap mode
                library_ms=_time_ms(lambda: F.grid_sample(
                    x_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)),
            )
            per_shape.append(row)
            if path == _MAIN and name == "hwarp" and c == 3:
                fs = field(shape[:3], d, "smooth")
                errs[name].append(_check(f"hwarp {shape} d={d} {mode} smooth field", hwarp(x, fs, d, mode), hwarp_plain(x, fs, d, mode)))
                _say(f"  hwarp {shape} on the smooth field: {_time_ms(lambda: hwarp(x, fs, d, mode)):.4f} ms "
                     f"(random field: {row['ms']:.4f} ms)")
                del fs
            del x, f, fc, zero, u, v, grid

    # The whole-clip path first (a kernel's first row is its row of the
    # `kernels` line), then every other path at its own shapes: its pyramid
    # levels in its dtype, its render dispatches (block length, width and
    # buckets), and the trainer's image warps.
    for path in [_MAIN] + [p for p in paths if p != _MAIN]:
        cv_rows(path, f32_too=path == _MAIN)
        warp_rows(path)
        if path == _MAIN:
            extra_warp_checks()
        image_warp_rows(path)
        render_rows(path)
    for row in per_shape:
        _bound(row, hbm)
        _say(f"  kernel {json.dumps(row)}")
        # A kernel's first row is its largest shape on the whole-clip path
        # (for vwarp on the pipeline's kind of field); its error is the
        # largest over all its shapes on every path.
        first = rows.setdefault(row["kernel"], dict(row))
        first["max_abs_err"] = max(first["max_abs_err"], row["max_abs_err"])
    return rows, per_shape, floor_ms


def device_time_line(per_shape, device_ms, floor_ms) -> None:
    """For each kernel, the sum over its whole-clip shapes of launches x ms (timed alone,
    inputs as the timing loop leaves them in the caches) beside the device
    time the profiler gave its device functions in one run of the main path.
    An event-timed call carries the gaps around a launch, which the profiler's
    kernel durations do not: the same sum with the launch floor taken off
    every call is printed too, and the profiler's time should lie between."""
    if device_ms is None:
        _say("kernel device time: not measured (the profiler recorded no device time)")
        return
    out = {}
    for name, key in _DEVICE_NAMES.items():
        mine = [r for r in per_shape if r["kernel"] == name and r["path"] == _MAIN]
        out[name] = {
            "sum_launches_x_ms": sum(r["launches"] * r["ms"] for r in mine),
            "sum_launches_x_ms_less_floor": sum(r["launches"] * (r["ms"] - floor_ms) for r in mine),
            "profiler_ms": sum(ms for k, (ms, _) in device_ms.items() if key in k),
            "profiler_launches": sum(n for k, (_, n) in device_ms.items() if key in k),
        }
        if out[name]["profiler_launches"] == 0:
            raise AssertionError(f"the profiler saw no device function of {name} ({key!r})")
    _say("kernel device time per run: " + json.dumps(out))


def _run_counted(name: str, run):
    """Drives one path with every launch counter zeroed just before and read
    just after; every kernel must have launched. Returns (result, launches,
    seconds)."""
    from vstab_torch.kernels import KERNELS, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v.launches for k, v in KERNELS.items()}
    _say(f"{name}: first run {dt:.2f} s, launches {json.dumps(launches)}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path {name}: {missing}")
    return out, launches, dt


def _check_frames(name: str, out, shape) -> None:
    out = torch.as_tensor(out)
    finite = bool(torch.isfinite(out).all())
    if tuple(out.shape) != tuple(shape) or not finite:
        raise AssertionError(f"{name}: bad output: shape {tuple(out.shape)}, finite {finite}")


def _flow_chunks(pairs: int) -> int:
    """Chunks of 8 frame pairs that `clip_flow` runs for `pairs` pairs (up to 2.2 megapixels)."""
    return -(-pairs // 8)


def _bucket(frames: torch.Tensor, params: dict, cfg) -> tuple:
    """(residual bound, render bucket) of the path `stabilize` solves on these frames."""
    from vstab_torch.pipeline import clip_flow, render_bucket, smooth_paths

    hw = tuple(frames.shape[1:3])
    return render_bucket(smooth_paths(clip_flow(params, frames, cfg), cfg, hw)[0], cfg, hw)


def _close(name: str, got, want, tol: float = 2e-3, share: float = 0.999) -> None:
    """At least `share` of the values within `tol`: the rest sit where the
    0.999 validity threshold or a bilinear tap flips."""
    err = (torch.as_tensor(got).cuda() - torch.as_tensor(want).cuda()).abs()
    within = float((err <= tol).float().mean())
    _say(f"  {name}: max_abs_err {float(err.max()):.3e}, {within:.5f} of values within {tol:g}")
    if within < share:
        raise AssertionError(f"{name}: outputs disagree")


def main_path(card: str):
    import vstab_torch
    from vstab_torch import bench
    from vstab_torch.eval.synthetic import make_shaky_clip
    from vstab_torch.pipeline import _params_match

    cfg = vstab_torch.Config()  # default: bf16 flow, sparse_ls, adaptive bound
    t0 = time.perf_counter()
    params = vstab_torch.default_params(cfg, ckpt_dir="ckpts")
    if not _params_match(params, cfg.flow) or len(params) != 126:
        raise AssertionError("flow_086000 did not load into the default PWCNet")
    n_par = sum(v.numel() for v in params.values())
    _say(f"params: {len(params)} tensors, {n_par} values from ckpts/flow_086000.msgpack "
         f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    frames_np, _ = make_shaky_clip(t=48, h=720, w=1280, seed=0)
    frames = torch.from_numpy(frames_np).cuda()
    _say(f"clip: {tuple(frames.shape)} synthesized in {time.perf_counter() - t0:.1f} s")

    (out, _), launches, _ = _run_counted("main path", lambda: vstab_torch.stabilize(frames, params, cfg))
    _check_frames("main path", out, (48, 720, 1280, 3))
    valid = float((out != 0).any(dim=-1).float().mean())
    _say(f"output: {tuple(out.shape)} finite, non-border pixels {valid:.4f}")
    del out

    res = bench.measure(frames, params, cfg, iters=3, stages=True)
    _say("main path: " + json.dumps({**res, "card": card}))
    device_ms = profile(lambda: vstab_torch.stabilize(frames, params, cfg))
    path = {"hw": (720, 1280), "n": 48, "renders": {res["max_disp"]: 1}, "chunks": _flow_chunks(47),
            "launches": launches}
    return path, device_ms, frames_np, frames, params


def affine_phase(frames: torch.Tensor, params: dict, card: str) -> dict:
    """`stabilize` with the global-affine smoothing on the main clip, and the
    small clip's card-against-CPU check for that method."""
    import vstab_torch
    from vstab_torch import bench

    base = vstab_torch.Config()
    cfg = dataclasses.replace(base, smooth=dataclasses.replace(base.smooth, method="affine"))
    t, h, w, _ = frames.shape
    (out, _), launches, _ = _run_counted("affine", lambda: vstab_torch.stabilize(frames, params, cfg))
    _check_frames("affine", out, frames.shape)
    res = bench.measure(frames, params, cfg, iters=3, stages=True)
    _say("affine: " + json.dumps({
        **res, "non_border_pixels": float((out != 0).any(dim=-1).float().mean()), "card": card}))
    small_clip_check("affine")
    return {"hw": (h, w), "n": t, "renders": {res["max_disp"]: 1}, "chunks": _flow_chunks(t - 1),
            "launches": launches}


def batch_phase(frames: torch.Tensor, params: dict, card: str) -> dict:
    """`stabilize_batch` on the clip and its time reverse: each clip's output
    against `stabilize` on that clip with the batch's bucket."""
    import vstab_torch
    from vstab_torch.render.render import pick_max_disp

    cfg = vstab_torch.Config()
    t, h, w, _ = frames.shape
    batch = torch.stack([frames, frames.flip(0)])
    torch.cuda.reset_peak_memory_stats()
    out, launches, dt = _run_counted("batch", lambda: vstab_torch.stabilize_batch(batch, params, cfg))
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_frames("batch", out, batch.shape)
    bounds = [_bucket(clip, params, cfg)[0] for clip in batch]
    d = pick_max_disp(max(bounds), cfg.render)
    static = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, adaptive_max_disp=False, max_residual_disp=d))
    for i, clip in enumerate(batch):
        _close(f"batch clip {i} vs stabilize at the batch's bucket {d}",
               out[i], vstab_torch.stabilize(clip, params, static)[0])
    _say("batch: " + json.dumps({
        "clips": 2, "frames_per_s": 2 * t / dt, "run_s": dt, "residual_bounds_px": bounds,
        "max_disp": d, "peak_mem_gb": peak, "card": card,
    }))
    return {"hw": (h, w), "n": t, "renders": {d: 2}, "chunks": 2 * _flow_chunks(t - 1),
            "launches": launches}


def _median_s(run, iters: int = 3) -> float:
    """Seconds of one run: one warm run, then the median of `iters`."""
    run()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def sharded_phase(frames_np: np.ndarray, params: dict, card: str) -> dict:
    """`stabilize_sharded` through a one-rank group of the port's backend
    (`BACKEND`: NCCL for the CUDA tensors) on the main clip
    (host frames), with the sparse-LS and the affine smoothing, each against
    `stabilize` on the clip padded with freeze frames as the sharded path
    pads it (the same bucket, 99.9% of the values within 2e-3); then the
    real frames/s (one warm run, the median of three) of the sharded path and
    of `stabilize` on the T real and on the T_pad padded frames, all from
    host frames, the peak device memory, the NCCL version and, for sparse-LS,
    one profiled run. Returns the two paths for `kernel_phase`: one rank holds
    T_pad frames, so its flow runs T_pad pairs (the last a freeze pair) and
    its render one dispatch of T_pad frames."""
    import socket

    import torch.distributed as dist
    import vstab_torch
    from vstab_torch.dist import make_mesh, stabilize_sharded
    from vstab_torch.dist.init import BACKEND

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(BACKEND, init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    paths = {}
    try:
        mesh = make_mesh()
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
        base = vstab_torch.Config()
        t, h, w, _ = frames_np.shape
        for name, method in (("sharded_720p", "sparse_ls"), ("sharded_affine_720p", "affine")):
            cfg = dataclasses.replace(base, smooth=dataclasses.replace(base.smooth, method=method))
            run = lambda: stabilize_sharded(frames_np, params, cfg, mesh=mesh, gather=True)
            torch.cuda.reset_peak_memory_stats()
            (out, diags), launches, first_s = _run_counted(name, run)
            peak = torch.cuda.max_memory_allocated() / 1e9
            _check_frames(name, out, (t, h, w, 3))
            t_pad = diags["t_pad"]
            padded_np = frames_np[np.minimum(np.arange(t_pad), t - 1)]
            padded = torch.from_numpy(padded_np).cuda()
            bound, d = _bucket(padded, params, cfg)
            if diags["max_disp"] != d:
                raise AssertionError(f"{name}: bucket {diags['max_disp']}, stabilize on the padded clip {d}")
            want = vstab_torch.stabilize(padded, params, cfg)[0][:t]
            _close(f"{name} vs stabilize on the clip padded to {t_pad} frames", out, want)
            del padded, want
            # Not held: the T real frames alone solve a shorter path.
            unpadded_bound, unpadded_d = _bucket(torch.from_numpy(frames_np).cuda(), params, cfg)
            whole = vstab_torch.stabilize(frames_np, params, cfg)[0]
            share = float(((out - whole).abs() <= 2e-3).float().mean())
            del out, whole
            sharded_s = _median_s(run)
            whole_s = _median_s(lambda: vstab_torch.stabilize(frames_np, params, cfg))
            padded_s = _median_s(lambda: vstab_torch.stabilize(padded_np, params, cfg))
            _say(f"{name}: " + json.dumps({
                "method": method, "frames": t, "t_pad": t_pad, "ranks": 1, "backend": BACKEND, "nccl": nccl,
                "residual_bound_px": diags["residual_bound_px"], "max_disp": diags["max_disp"],
                "padded_stabilize_residual_bound_px": bound, "first_run_s": first_s,
                "frames_per_s": t / sharded_s, "run_s": sharded_s, "peak_mem_gb": peak,
                "stabilize_frames_per_s": t / whole_s, "stabilize_run_s": whole_s,
                "stabilize_residual_bound_px": unpadded_bound, "stabilize_max_disp": unpadded_d,
                "stabilize_padded_run_s": padded_s, "vs_stabilize_share_within_2e-3": share,
                "all_from_host_frames": True, "card": card,
            }))
            if method == "sparse_ls":
                _say(f"{name}: profile of one more run ({card})")
                profile(run)
            paths[name] = {"hw": (h, w), "n": t_pad, "renders": {d: 1}, "chunks": _flow_chunks(t_pad),
                           "launches": launches}
    finally:
        dist.destroy_process_group()
    return paths


class _StatsCatcher(logging.Handler):
    """Keeps the stats dict that the blocked pipeline logs at the end of a run."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.stats = None

    def emit(self, record):
        if str(record.msg).startswith("blocked stabilize:"):
            self.stats = record.args if isinstance(record.args, dict) else record.args[0]


def _blocked_run(frames, params, cfg, block_len):
    import vstab_torch

    catcher = _StatsCatcher()
    log = logging.getLogger("vstab_torch.blocked")
    level = log.level
    log.addHandler(catcher)
    log.setLevel(logging.INFO)
    try:
        out = vstab_torch.stabilize_blocked(frames, params, cfg, block_len=block_len)
    finally:
        log.removeHandler(catcher)
        log.setLevel(level)
    if catcher.stats is None:
        raise AssertionError("the blocked run logged no stats")
    return out, catcher.stats


def blocked_phase(name: str, u8: np.ndarray, params: dict, block_len: int, card: str) -> dict:
    """`stabilize_blocked` on host frames [T,H,W,3] uint8, once as float32
    (u8 / 255) and once as uint8, against `stabilize` on the float32 clip on
    the card: the same `max_disp`, 99.9% of the values within 2e-3. bf16 flow
    and cuDNN's choice of algorithm are the same in both (chunks of 8 pairs at
    one frame size); what differs is the grouping of pairs into chunks."""
    import vstab_torch

    cfg = vstab_torch.Config()
    t, h, w, _ = u8.shape
    f32 = u8.astype(np.float32) * np.float32(1.0 / 255.0)  # the device's arithmetic
    dev_frames = torch.from_numpy(f32).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vstab_torch.stabilize(dev_frames, params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, _ = vstab_torch.stabilize(dev_frames, params, cfg)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    whole_peak = torch.cuda.max_memory_allocated() / 1e9
    bound, d = _bucket(dev_frames, params, cfg)
    want = want.cpu()
    del dev_frames
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    (got, stats), launches, _ = _run_counted(
        f"{name} float32", lambda: _blocked_run(f32, params, cfg, block_len))
    blocked_peak = torch.cuda.max_memory_allocated() / 1e9
    _check_frames(name, got, (t, h, w, 3))
    if stats["max_disp"] != d:
        raise AssertionError(f"{name}: blocked max_disp {stats['max_disp']} != whole-clip {d}")
    _close(f"{name} float32 vs whole clip", got, want)
    _, stats_f32 = _blocked_run(f32, params, cfg, block_len)  # warm: pinned buffers are cached now
    (got8, stats_u8), launches_u8, _ = _run_counted(
        f"{name} uint8", lambda: _blocked_run(u8, params, cfg, block_len))
    if stats_u8["max_disp"] != d:
        raise AssertionError(f"{name}: uint8 max_disp {stats_u8['max_disp']} != whole-clip {d}")
    if launches_u8 != launches:
        raise AssertionError(f"{name}: the uint8 run launched {launches_u8}, the float32 run {launches}")
    _close(f"{name} uint8 vs whole clip", got8, want)
    del got, got8, want
    _say(f"{name}: " + json.dumps({
        "frames": t, "hw": [h, w], "block_len": block_len, "residual_bound_px": bound, "max_disp": d,
        "whole_clip": {"frames_per_s": t / whole_s, "run_s": whole_s, "peak_mem_gb": whole_peak},
        "blocked_first_run_float32": stats, "blocked_float32": stats_f32, "blocked_uint8": stats_u8,
        "blocked_peak_mem_gb": blocked_peak, "card": card,
    }))
    _say(f"{name}: profile of one more blocked float32 run ({card})")
    profile(lambda: vstab_torch.stabilize_blocked(f32, params, cfg, block_len=block_len))
    fetch_ab(name, {"float32": f32, "uint8": u8}, params, cfg, block_len, card)
    blocks = -(-t // block_len)  # each padded to block_len pairs for the flow, one render dispatch
    return {"hw": (h, w), "n": min(block_len, t), "renders": {d: blocks}, "chunks": blocks * _flow_chunks(block_len),
            "launches": launches}


class _PlainFetch:
    """`tensor.cpu()` at the drain, in place of the blocked pipeline's fetch
    on a second stream: what `fetch_ab` compares it with."""

    def __init__(self, x: torch.Tensor, copy_stream):
        self._x = x

    def result(self) -> np.ndarray:
        return self._x.cpu().numpy()


def fetch_ab(name: str, inputs: dict, params: dict, cfg, block_len: int, card: str) -> None:
    """Frames/s of warm blocked runs with the pipeline's second-stream fetch
    (`_Fetch`) and with a plain `.cpu()`, on the same frames in the order
    stream, plain, plain, stream."""
    from vstab_torch import pipeline_blocked as pb

    stream = pb._Fetch
    res = {}
    try:
        for kind, frames in inputs.items():
            fps = {"stream": [], "plain": []}
            for how in ("stream", "plain", "plain", "stream"):
                pb._Fetch = stream if how == "stream" else _PlainFetch
                fps[how].append(_blocked_run(frames, params, cfg, block_len)[1]["fps_processed"])
            res[kind] = fps
    finally:
        pb._Fetch = stream
    _say(f"{name} fetch A/B: " + json.dumps({"fps_processed": res, "card": card}))


def render_memory_probe(card: str) -> None:
    """Peak device memory of one 64-frame 1080p uint8 render dispatch of the
    blocked pipeline at the bucket 127: what `_RENDER_PX_FRAMES_BUDGET` lets
    through at 1080p."""
    import vstab_torch
    from vstab_torch.pipeline_blocked import _block_render

    cfg = vstab_torch.Config()
    g = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randint(0, 256, (64, 1080, 1920, 3), generator=g, device="cuda", dtype=torch.uint8)
    path = (torch.rand((64, 12, 16, 2), generator=g, device="cuda") * 2 - 1) * 60.0
    scale = torch.tensor(cfg.render.fixed_crop_ratio, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = _block_render(frames, path, scale, cfg, max_disp=127, to_uint8=True)
    torch.cuda.synchronize()
    _check_frames("render probe", out.float(), (64, 1080, 1920, 3))
    _say("render dispatch 64x1080x1920 uint8, d=127: " + json.dumps({
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "inputs_gb": base / 1e9, "card": card}))


def file_phase(u8: np.ndarray, have_cv2: bool, card: str) -> None:
    """File to file through the command line, where OpenCV is installed."""
    if not have_cv2:
        _say("file to file: not run, this machine has no cv2 (OpenCV)")
        return
    from vstab_torch.io.video import probe_video, write_video

    tmp = tempfile.mkdtemp(prefix="vstab_smoke_")
    try:
        src, dst = os.path.join(tmp, "in.mp4"), os.path.join(tmp, "out.mp4")
        write_video(src, u8, fps=30.0)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "vstab_torch", "stabilize", src, dst, "--blocked", "--block-len", "16"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        if r.returncode != 0:
            raise AssertionError(f"the command line failed ({r.returncode}):\n{r.stderr[-3000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        n_out, _, hw = probe_video(dst)
        _say("file to file: " + json.dumps({
            **rec, "subprocess_s": time.perf_counter() - t0, "output_frames": n_out, "card": card}))
        if rec["frames"] != u8.shape[0] or n_out != u8.shape[0] or hw != tuple(u8.shape[1:3]):
            raise AssertionError(f"file to file: {rec['frames']} / {n_out} frames of {hw}, wanted {u8.shape}")
        if rec["block_len"] != 16 or "motion block 1/" not in r.stderr or os.path.exists(dst + ".resume"):
            raise AssertionError("file to file: not the blocked path, or its resume directory was left")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile(run):
    """One more run under torch.profiler: device time by kernel name, and the
    device's busy time (the union of its kernel and copy intervals) against
    the run's wall time. Returns {name: (ms, count)}, or None when the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Raw device-side events (kernels, copies, memsets); the host ops that
    # launched them are CPU events and are left out.
    spans, by_name = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or ev.duration_ns() <= 0:
            continue
        if ev.name().startswith("Optimizer."):  # torch's own annotation over an optimizer step, no kernel
            continue
        spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        ms, count = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, count + 1)
    if not spans:
        _say("profile: the profiler recorded no device time (not measured)")
        return None
    busy_ns, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    _say("profile: " + json.dumps({
        "wall_ms": wall_ms, "device_busy_ms": busy_ns / 1e6,
        "device_idle_share": max(0.0, 1.0 - busy_ns / 1e6 / wall_ms),
        "device_events": len(spans),
    }))
    rows = sorted(((ms, n, key) for key, (ms, n) in by_name.items()), reverse=True)
    for ms, count, key in rows[:15]:
        _say(f"  {ms:9.3f} ms  {count:5d}x  {key[:110]}")
    return by_name


def small_clip_check(method: str = "sparse_ls"):
    """The card's output vs the CPU run of the plain versions, f32 flow."""
    import vstab_torch
    from vstab_torch.eval.synthetic import make_shaky_clip

    base = vstab_torch.Config()
    cfg = dataclasses.replace(
        base, flow=dataclasses.replace(base.flow, compute_dtype="float32"),
        smooth=dataclasses.replace(base.smooth, method=method))
    frames, _ = make_shaky_clip(t=9, h=64, w=96, seed=0)
    params = vstab_torch.default_params(cfg, ckpt_dir="ckpts", device="cpu")
    want, _ = vstab_torch.stabilize(frames, params, cfg, device="cpu")
    got, _ = vstab_torch.stabilize(frames, params, cfg)
    err = (got.cpu() - want).abs()
    share = float((err <= 1e-3).float().mean())
    _say(f"small clip (9x64x96, f32, {method}): card vs CPU plain max_abs_err {float(err.max()):.3e}, "
         f"{share:.5f} of pixels within 1e-3")
    if share < 0.999:
        raise AssertionError("card output disagrees with the CPU plain path")


def schur_check():
    from vstab_torch.core.config import SmoothConfig
    from vstab_torch.smooth.sparse_ls import smooth_profiles

    rng = np.random.default_rng(0)
    c = torch.from_numpy(
        np.cumsum(rng.normal(size=(128, 12, 16, 2)), axis=0).astype(np.float32)
    ).cuda()
    schur = smooth_profiles(c, SmoothConfig(block_len=32))  # 128 >= 3*32: Schur
    banded = smooth_profiles(c, SmoothConfig(block_len=64))  # 128 < 3*64: banded
    err = float((schur - banded).abs().max())
    _say(f"schur vs banded (T=128, |C| <= {float(c.abs().max()):.1f}): max_abs_err {err:.3e} (tol 5e-3)")
    if not err <= 5e-3:
        raise AssertionError("Schur solve disagrees with the banded solve")


# ---------------------------------------------------------------------------
# Training: backward kernels, the trainer, the checkpoint, the eval sweep
# ---------------------------------------------------------------------------

_TRAIN_HW, _TRAIN_BATCH = (192, 256), 8
# Gradient tolerances, relative to the largest value of the gradient compared:
# f32 1e-5 (another summation order), bf16 one bf16 ulp (both sum in f32 and
# round once).
_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def _check_grad(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} against {tuple(want.shape)} {want.dtype}")
    scale = float(want.float().abs().max())
    tol = _GRAD_TOL[want.dtype] * scale
    err = float((got.float() - want.float()).abs().max())
    _say(f"  check {name}: shape {tuple(got.shape)} {got.dtype} max_abs_err {err:.3e} "
         f"(tol {_GRAD_TOL[want.dtype]:g} * largest value {scale:.3e}) -> {'ok' if err <= tol else 'out'}")
    if not err <= tol:
        raise AssertionError(f"{name}: backward kernel disagrees")
    return err


def _dt(dtype) -> str:
    return str(dtype).split(".")[1]


def _graph_nodes(run) -> list:
    """The device work of one call of `run`, exactly: a CUDA-graph capture of
    the call, with nothing run, and the type of each node the graph holds
    (CUDA's CUgraphNodeType: 0 a kernel, 1 a copy, 2 a memset, ...). A
    call runs once first, so that what it sets up once stays out."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def check(err):
        if err:
            raise RuntimeError(f"CUDA driver call failed ({err})")

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        run()
    raw, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(count)))
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)))
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        types.append(kind.value)
    del graph
    return types


def _host_us(run, calls: int = 1000) -> float:
    """Host time a call: the wall time of `calls` calls issued back to back,
    read before the device is waited for, over `calls` (microseconds)."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def backward_kernel_phase(hbm: float):
    """Checks and times the two backward kernels; returns (rows, per_shape) like
    `kernel_phase`. A kernel's first row is the finest level of a training
    step in f32 (the trainer's default dtype); launches are per training step."""
    from vstab_torch.kernels import (
        KERNELS_BWD, bilinear_warp, bilinear_warp_backward, bilinear_warp_backward_plain, bilinear_warp_plain,
        cost_volume, cost_volume_backward, cost_volume_backward_plain, cost_volume_plain,
    )
    from vstab_torch.kernels.warp import ROUTE_GATHER, ROUTE_SCATTER, UNBOUNDED, backward_route

    gen = torch.Generator(device="cuda").manual_seed(1)
    per_shape, rows = [], {}
    levels = _level_shapes(*_TRAIN_HW, pairs=_TRAIN_BATCH)
    hd_level = _level_shapes(720, 1280)[0]

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def cv_case(shape, dtype, r, timed, launches=0):
        n, h, w, c = shape
        nd = (2 * r + 1) ** 2
        f1, f2 = randn(shape, dtype).requires_grad_(), randn(shape, dtype).requires_grad_()
        # a ramp over the window: a transposed shift in df2 would show
        g = (randn((n, h, w, nd), torch.float32) * torch.linspace(0.2, 1.8, nd, device="cuda")).to(dtype)
        # Through autograd, as a training step reaches the kernel; the timed
        # call is the backward wrapper itself, without the autograd engine's
        # thread between the host and the launch.
        before = KERNELS_BWD["cost_volume_bwd"].launches
        df1, df2 = torch.autograd.grad(cost_volume(f1, f2, r), (f1, f2), g)
        if KERNELS_BWD["cost_volume_bwd"].launches != before + 1:
            raise AssertionError("the cost volume's backward did not launch its kernel once")
        run = lambda: cost_volume_backward(g, f1.detach(), f2.detach(), r)
        if not all(torch.equal(a, b) for a, b in zip(run(), (df1, df2))):
            raise AssertionError("cost_volume_backward differs from the gradient autograd returned")
        name = f"cost_volume_bwd {shape} {_dt(dtype)} r={r}"
        p1, p2 = cost_volume_backward_plain(g, f1.detach(), f2.detach(), r)
        a1, a2 = torch.autograd.grad(cost_volume_plain(f1, f2, r), (f1, f2), g)
        err = max(_check_grad(f"{name} df1 vs plain", df1, p1), _check_grad(f"{name} df2 vs plain", df2, p2),
                  _check_grad(f"{name} df1 vs autograd", df1, a1), _check_grad(f"{name} df2 vs autograd", df2, a2))
        if not timed:
            return err
        size = f1.element_size()
        per_shape.append(dict(
            kernel="cost_volume_bwd", path="train", shape=list(shape) + [_dt(dtype), f"r={r}"],
            launches=launches, max_abs_err=err, ms=_time_ms(run),
            plain_ms=_time_ms(lambda: cost_volume_backward_plain(g, f1.detach(), f2.detach(), r), iters=5),
            bytes=(g.numel() + 4 * f1.numel()) * size, flops=2 * n * h * w * nd * c * 2,
            rate=_BF16_RATE if dtype == torch.bfloat16 else _F32_RATE, library_ms=None,
        ))
        return err

    def warp_case(shape, dtype, flow_dtype, timed, launches=0, amp=7.9, max_disp=8, edges=False):
        n, h, w, c = shape
        img = randn(shape, dtype).requires_grad_()
        flow = (torch.rand((n, h, w, 2), generator=gen, device="cuda") * 2 - 1) * amp
        if edges:  # every corner block points off both of its edges
            k = 3
            flow[:, :k, :k], flow[:, -k:, -k:] = -amp, amp
            flow[:, :k, -k:, 0], flow[:, :k, -k:, 1] = amp, -amp
            flow[:, -k:, :k, 0], flow[:, -k:, :k, 1] = -amp, amp
        flow = flow.to(flow_dtype).requires_grad_()
        g = randn(shape, dtype)
        before = KERNELS_BWD["bilinear_warp_bwd"].launches
        dimg, dflow = torch.autograd.grad(bilinear_warp(img, flow, max_disp), (img, flow), g)
        if KERNELS_BWD["bilinear_warp_bwd"].launches != before + 1:
            raise AssertionError("the feature warp's backward did not launch its kernel once")
        run = lambda: bilinear_warp_backward(g, img.detach(), flow.detach(), max_disp)
        name = f"bilinear_warp_bwd {shape} {_dt(dtype)} flow {_dt(flow_dtype)} in +-{amp:g}, max_disp {max_disp}"
        # The kernel clips the flow and passes no gradient where it did; the
        # plain version has no clip, so it gets the clipped flow and its flow
        # gradient is masked. Inside +-max_disp both steps change nothing.
        fl = flow.detach().float()
        inside = (fl.abs() <= max_disp).float()
        clipped = fl.clamp(-max_disp, max_disp)
        pimg, pflow = bilinear_warp_backward_plain(g, img.detach(), clipped.to(flow_dtype))
        pflow = (pflow.float() * inside).to(flow_dtype)
        # autograd of the plain forward on f32 copies (on bf16 leaves it would
        # add the image gradient up in bf16), clip included
        i32, f32 = img.detach().float().requires_grad_(), fl.clone().requires_grad_()
        aimg, aflow = torch.autograd.grad(
            bilinear_warp_plain(i32, f32.clamp(-max_disp, max_disp)), (i32, f32), g.float())
        err = max(_check_grad(f"{name} dimg vs plain", dimg, pimg),
                  _check_grad(f"{name} dimg vs autograd", dimg, aimg.to(dtype)))
        _check_grad(f"{name} dflow vs plain", dflow, pflow)
        _check_grad(f"{name} dflow vs autograd", dflow, aflow.to(flow_dtype))
        share = float(inside.mean())
        if float((dflow.float() * (1 - inside)).abs().max()) != 0.0:
            raise AssertionError(f"{name}: a flow gradient where the flow was clipped")
        if not timed:
            return err, share
        # The one library call with the same function: grid_sample's backward
        # (bilinear, border padding, align_corners), called as an operator.
        img_nchw = img.detach().permute(0, 3, 1, 2)
        grid = _grid(h, w, clipped[..., 0], clipped[..., 1], dtype)
        g_nchw = g.permute(0, 3, 1, 2)
        library = lambda: torch.ops.aten.grid_sampler_2d_backward(
            g_nchw, img_nchw, grid, 0, 1, True, (True, True))
        isz, fsz = img.element_size(), flow.element_size()
        # g, img, flow read; dimg and dflow written, each in its own dtype
        moved = 3 * img.numel() * isz + 2 * flow.numel() * fsz
        per_shape.append(dict(
            kernel="bilinear_warp_bwd", path="train",
            shape=list(shape) + [_dt(dtype), f"{_dt(flow_dtype)} flow in +-{amp:g}"],
            launches=launches, max_abs_err=err, ms=_time_ms(run),
            plain_ms=_time_ms(lambda: bilinear_warp_backward_plain(g, img.detach(), flow.detach()), iters=5),
            bytes=moved, flops=None, library_ms=_time_ms(library),
            # the bound with the scatter's f32 buffer zeroed and written on
            # top, as the first version's rows counted it
            bound_ms_with_f32_buffer=(moved + 4 * img.numel()) / hbm * 1e3,
        ))
        return err, share

    def warp_bits(shape, dtype):
        """The gather's gradients at the trainer's finest warp level: equal
        to the bit in two calls, and for images 0, 3..4 and 7 alone against
        the batch of 8; a call captured in a CUDA graph holds one kernel and
        nothing else (no memset, no cast); the wrapper's host time a call."""
        n, h, w, _ = shape
        img, g = randn(shape, dtype), randn(shape, dtype)
        flow = ((torch.rand((n, h, w, 2), generator=gen, device="cuda") * 2 - 1) * 7.9).to(dtype)
        name = f"bilinear_warp_bwd {shape} {_dt(dtype)}"
        if backward_route(g, img, flow, 8, (True, True)) != ROUTE_GATHER:
            raise AssertionError(f"{name}: the network's warp does not take the gather")
        whole = bilinear_warp_backward(g, img, flow, 8)
        if not all(torch.equal(a, b) for a, b in zip(bilinear_warp_backward(g, img, flow, 8), whole)):
            raise AssertionError(f"{name}: two calls differ")
        for lo, hi in ((0, 1), (3, 5), (7, 8)):
            part = bilinear_warp_backward(g[lo:hi].contiguous(), img[lo:hi].contiguous(),
                                          flow[lo:hi].contiguous(), 8)
            if not all(torch.equal(a, b[lo:hi]) for a, b in zip(part, whole)):
                raise AssertionError(f"{name}: images {lo}..{hi - 1} alone differ from the batch")
        call = lambda: bilinear_warp_backward(g, img, flow, 8)
        nodes = _graph_nodes(call)
        host = _host_us(call)
        _say(f"  {name}: dimg, dflow equal to the bit in two calls and for images 0, 3..4, 7 alone "
             f"and in the batch; the device nodes of one call (0 = kernel): {nodes}; "
             f"host {host:.2f} us a call (1000 calls)")
        if nodes != [0]:
            raise AssertionError(f"{name}: a call launches {nodes}, not one kernel and nothing else")

    def flow_only_case(shape, timed):
        """The photometric loss's call: C = 3, UNBOUNDED, the flow's
        gradient alone (the first version with no image gradient: a gather),
        against the plain version."""
        n, h, w, c = shape
        img, g = randn(shape, torch.float32), randn(shape, torch.float32)
        flow = (torch.rand((n, h, w, 2), generator=gen, device="cuda") * 2 - 1) * 30.0
        name = f"bilinear_warp_bwd {shape} f32 flow only, UNBOUNDED"
        if backward_route(g, img, flow, UNBOUNDED, (False, True)) != ROUTE_SCATTER:
            raise AssertionError(f"{name}: not the first version's route")
        run = lambda: bilinear_warp_backward(g, img, flow, UNBOUNDED, need=(False, True))
        before = KERNELS_BWD["bilinear_warp_bwd"].launches
        none, dflow = run()
        if none is not None or KERNELS_BWD["bilinear_warp_bwd"].launches != before + 1:
            raise AssertionError(f"{name}: not one launch and no image gradient")
        err = _check_grad(f"{name} dflow vs plain", dflow, bilinear_warp_backward_plain(g, img, flow)[1])
        if timed:
            # the library's: grid_sample's backward, the grid's gradient alone
            grid = _grid(h, w, flow[..., 0], flow[..., 1], torch.float32)
            g_nchw, img_nchw = g.permute(0, 3, 1, 2), img.permute(0, 3, 1, 2)
            library = lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_nchw, img_nchw, grid, 0, 1, True, (False, True))
            per_shape.append(dict(
                kernel="bilinear_warp_bwd", path="train photometric", shape=list(shape) + ["f32", "flow only"],
                launches=0, max_abs_err=err, ms=_time_ms(run),
                plain_ms=_time_ms(lambda: bilinear_warp_backward_plain(g, img, flow), iters=5),
                # g, img, flow read; dflow written
                bytes=2 * img.numel() * 4 + 2 * flow.numel() * 4, flops=None, library_ms=_time_ms(library),
            ))
        return err

    # A training step launches each backward kernel once a level: the cost
    # volume at five, the feature warp at the four finest. f32 rows first.
    for dtype in (torch.float32, torch.bfloat16):
        for shape in levels:
            cv_case(shape, dtype, 4, timed=True, launches=1 if dtype == torch.float32 else 0)
    cv_case(hd_level, torch.bfloat16, 4, timed=True)  # the 720p level, beside the forward's row
    # An image's gradients are the same to the bit alone, two at a time and
    # in the batch of 8 at the finest level: the kernel's tile, and with it
    # the order of a pixel's sums, follows from the image size alone.
    f1, f2 = randn(levels[0], torch.float32), randn(levels[0], torch.float32)
    g = randn(levels[0][:3] + (81,), torch.float32)
    whole = cost_volume_backward(g, f1, f2, 4)
    for lo, hi in ((0, 1), (3, 5), (7, 8)):
        part = cost_volume_backward(g[lo:hi].contiguous(), f1[lo:hi].contiguous(), f2[lo:hi].contiguous(), 4)
        if not all(torch.equal(a, b[lo:hi]) for a, b in zip(part, whole)):
            raise AssertionError(f"cost_volume_bwd {levels[0]}: images {lo}..{hi - 1} alone differ from the batch")
    _say(f"  cost_volume_bwd {levels[0]} f32: df1, df2 of images 0, 3..4, 7 alone equal to the bit to the batch's")
    del f1, f2, g, whole, part
    for dtype in (torch.float32, torch.bfloat16):
        for shape in levels[:4]:
            warp_case(shape, dtype, dtype, timed=True, launches=1 if dtype == torch.float32 else 0)
    warp_case(hd_level, torch.bfloat16, torch.bfloat16, timed=True)
    flow_only_case((levels[0][0], levels[0][1], levels[0][2], 3), timed=True)
    for dtype in (torch.float32, torch.bfloat16):
        warp_bits(levels[0], dtype)
    # Checked, not timed: channel counts off the vector widths, a smaller
    # radius, mixed dtypes, flow off every edge, the 3-channel unclipped warp
    # of the photometric loss, and a flow half of which the forward clips.
    extra = {"cost_volume_bwd": [], "bilinear_warp_bwd": []}
    for dtype in (torch.float32, torch.bfloat16):
        extra["cost_volume_bwd"] += [cv_case((2, 13, 20, 21), dtype, 2, timed=False),
                                     cv_case((1, 6, 8, 196), dtype, 1, timed=False)]
        extra["bilinear_warp_bwd"].append(warp_case((2, 19, 24, 21), dtype, dtype, timed=False, edges=True)[0])
    extra["bilinear_warp_bwd"].append(
        warp_case((2, 19, 24, 32), torch.bfloat16, torch.float32, timed=False, edges=True)[0])
    extra["bilinear_warp_bwd"].append(
        warp_case((2, 19, 24, 32), torch.float32, torch.bfloat16, timed=False, edges=True)[0])
    extra["bilinear_warp_bwd"].append(
        warp_case((2, 48, 64, 3), torch.float32, torch.float32, timed=False, amp=30.0, max_disp=UNBOUNDED, edges=True)[0])
    err, share = warp_case((2, 24, 32, 64), torch.float32, torch.float32, timed=False, amp=12.0, edges=True)
    extra["bilinear_warp_bwd"].append(err)
    _say(f"  clipped-flow case: {share:.3f} of the flow components inside +-8, zero flow gradient outside")
    if not 0.3 < share < 0.9:
        raise AssertionError("the clipped-flow case clips too little or too much to show anything")
    for row in per_shape:
        _bound(row, hbm)
        _say(f"  kernel {json.dumps(row)}")
        first = rows.setdefault(row["kernel"], dict(row))
        first["max_abs_err"] = max(first["max_abs_err"], row["max_abs_err"], *extra[row["kernel"]])
    return rows, per_shape


def _all_launches() -> dict:
    from vstab_torch.kernels import KERNELS, KERNELS_BWD

    return {k: v.launches for k, v in {**KERNELS, **KERNELS_BWD}.items()}


def _gradient_cross_check(params: dict, cfg, batch: dict, mode: str) -> None:
    """Every parameter's gradient of one training loss through the kernels
    against the same loss with the plain versions swapped in on the card
    (the plain warp given the flow clipped as the kernel clips it): relative
    1e-3 of each leaf's largest value. The photometric loss warps once more
    than the network does, forward and backward. cuDNN is held to its
    deterministic algorithms for both passes, so that they differ in the
    kernels only and the reading repeats. A network at its random init
    carries rounding-sized differences of the forward pass into its late
    layers' gradients several thousand times enlarged: for scale, two plain
    passes under cuDNN's default algorithms (which add with atomics) are
    compared as well, and printed."""
    import vstab_torch.flow.pwcnet as pw
    from vstab_torch.flow import train as T
    from vstab_torch.kernels import bilinear_warp_plain, cost_volume_plain

    def grads():
        net = T._trainable(params, cfg, torch.device("cuda"))
        loss, _ = T.make_loss(net, mode)(batch)
        loss.backward()
        return float(loss.detach()), {k: p.grad for k, p in net.named_parameters()}

    warps = 4 + (mode == "photometric")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    before = _all_launches()
    loss_k, got = grads()
    after = _all_launches()
    used = {k: after[k] - before[k] for k in after}
    if (used["cost_volume"], used["bilinear_warp"], used["cost_volume_bwd"], used["bilinear_warp_bwd"]) != (5, warps, 5, warps):
        raise AssertionError(f"one {mode} forward and backward pass launched {used}")
    kernels = (pw.cost_volume, pw.bilinear_warp, T.bilinear_warp)
    plain_warp = lambda img, flow, max_disp: bilinear_warp_plain(img, flow.clamp(-max_disp, max_disp))
    pw.cost_volume = lambda f1, f2, radius: cost_volume_plain(f1, f2, radius)
    pw.bilinear_warp = T.bilinear_warp = plain_warp
    try:
        loss_p, want = grads()
        torch.backends.cudnn.deterministic = False
        plain_a, plain_b = grads()[1], grads()[1]
    finally:
        pw.cost_volume, pw.bilinear_warp, T.bilinear_warp = kernels
        torch.backends.cudnn.deterministic = was
    noise = max(float((plain_a[k] - plain_b[k]).abs().max()) / float(plain_b[k].abs().max()) for k in want)
    if _all_launches() != after:
        raise AssertionError("the plain pass launched a kernel")
    worst = 0.0
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        worst = max(worst, err / scale)
        if not (scale > 0 and err <= 1e-3 * scale):
            raise AssertionError(f"gradient of {k}: max_abs_err {err:.3e}, largest value {scale:.3e}")
    _say(f"  gradient cross-check, {mode}: {len(want)} leaves, loss {loss_k:.6f} (kernels) vs {loss_p:.6f} (plain), "
         f"worst leaf error {worst:.3e} of its largest value (tol 1e-3); "
         f"two plain passes under cuDNN's default algorithms: {noise:.3e}")
    if abs(loss_k - loss_p) > 1e-4 * abs(loss_p):
        raise AssertionError("the loss through the kernels differs from the plain one")


def _step_breakdown(params: dict, cfg, scenes: torch.Tensor, card: str) -> None:
    """ms a step on the device's timeline, split by CUDA events into batch
    generation, forward (network and loss), backward and optimizer; then the
    profiler's device time by kernel over one more step."""
    from vstab_torch.flow import train as T

    dev = torch.device("cuda")
    net = T._trainable(params, cfg, dev)
    opt = T.make_optimizer(net.parameters(), 2e-4)
    loss_fn, step = T.make_loss(net, "supervised"), T.make_train_step(net, opt, "supervised")
    gen = torch.Generator(device=dev).manual_seed(5)
    for _ in range(3):
        step(T._sample_batch(gen, scenes, _TRAIN_BATCH, 12.0))
    parts = {"batch": [], "forward": [], "backward": [], "optimizer": []}
    n_steps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        marks[0].record()
        batch = T._sample_batch(gen, scenes, _TRAIN_BATCH, 12.0)
        marks[1].record()
        opt.zero_grad(set_to_none=True)
        loss, _ = loss_fn(batch)
        marks[2].record()
        loss.backward()
        marks[3].record()
        opt.step()
        marks[4].record()
        for name, a, b in zip(parts, marks, marks[1:]):
            parts[name].append((a, b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = {k: sum(a.elapsed_time(b) for a, b in v) / n_steps for k, v in parts.items()}
    _say("train step: " + json.dumps({
        "ms_per_step": wall / n_steps * 1e3, "steps_per_s": n_steps / wall, "split_ms": split,
        "batch": _TRAIN_BATCH, "hw": list(_TRAIN_HW), "compute_dtype": cfg.compute_dtype, "card": card}))
    _say(f"train step: profile of one more step ({card})")
    by_name = profile(lambda: step(T._sample_batch(gen, scenes, _TRAIN_BATCH, 12.0)))
    if by_name is None:
        _say("backward kernels' device time in a step: not measured")
        return
    out = {}
    for key in ("cost_volume_bwd_kernel", "bilinear_warp_bwd_kernel", "cost_volume_f32_kernel", "bilinear_warp_"):
        hits = [(ms, n) for k, (ms, n) in by_name.items()
                if key in k and (key != "bilinear_warp_" or "bwd" not in k)]
        out[key] = {"device_ms": sum(ms for ms, _ in hits), "launches": sum(n for _, n in hits)}
    out["all_kernels_ms"] = sum(ms for ms, _ in by_name.values())
    _say("device time in one training step: " + json.dumps(out))
    if out["cost_volume_bwd_kernel"]["launches"] != 5 or out["bilinear_warp_bwd_kernel"]["launches"] != 4:
        raise AssertionError("the profiler did not see 5 and 4 launches of the backward kernels in a step")
    if out["cost_volume_f32_kernel"]["launches"] != 5:
        raise AssertionError("the profiler did not see 5 launches of the f32 cost volume in a step, one a level")


def _train_fast_logged(**kw):
    """`train_fast(**kw)` and the mean metrics of its chunks, read from the
    lines it prints (`step n/N: {...}`, values to four decimals)."""
    from vstab_torch.flow.train import train_fast

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = train_fast(**kw)
    finally:
        sys.stdout.write(buf.getvalue())
        sys.stdout.flush()
    lines = [line for line in buf.getvalue().splitlines() if line.startswith("step ")]
    return out, [ast.literal_eval(line.split(": ", 1)[1]) for line in lines]


def train_phase(card: str, tmp: str) -> dict:
    """The trainer at full width on the card; returns its path for
    `kernel_phase`: the f32 level shapes of a batch, the batch maker's image
    warps, and the launches of the 40-step run by kernel."""
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow import train as T
    from vstab_torch.flow.pwcnet import estimate_flow, init_params
    from vstab_torch.kernels import reset_launches
    from vstab_torch.utils.checkpoint import load_params, params_from_jax

    cfg = FlowConfig(compute_dtype="float32")
    dev = torch.device("cuda")
    steps, n_scenes, max_disp = 40, 64, 12.0
    t0 = time.perf_counter()
    scenes = torch.from_numpy(T.make_scene_pool(n_scenes, *_TRAIN_HW, seed=0)).to(dev)
    _say(f"train: {n_scenes} scenes of {_TRAIN_HW} made in {time.perf_counter() - t0:.1f} s")

    # step 1: gradients through the kernels against the plain versions
    init = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    batch = T._sample_batch(torch.Generator(device=dev).manual_seed(1), scenes, _TRAIN_BATCH, max_disp)
    _gradient_cross_check(init, cfg, batch, "supervised")
    pair = {"im1": batch["im1"], "im2": batch["im2"]}
    _gradient_cross_check(init, cfg, pair, "photometric")

    # 40 steps through the entry point, every launch counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trained, history = _train_fast_logged(
        cfg=cfg, steps=steps, batch_size=_TRAIN_BATCH, hw=_TRAIN_HW, seed=0, scan_len=10,
        n_scenes=n_scenes, max_disp=max_disp, ckpt_dir=tmp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # A step: 5 cost volumes and 4 feature warps forward and as many backward;
    # the batch's own 4 warps (the pair and three occluders) have no gradient.
    want = {"cost_volume": 5 * steps, "bilinear_warp": (4 + 4) * steps, "vwarp": 0, "hwarp": 0,
            "cost_volume_bwd": 5 * steps, "bilinear_warp_bwd": 4 * steps}
    _say("train: " + json.dumps({
        "steps": steps, "run_s": wall, "steps_per_s_with_setup": steps / wall, "chunks": history,
        "launches": launches, "peak_mem_gb": peak, "card": card}))
    if launches != want:
        raise AssertionError(f"train_fast launched {launches}, expected {want}")
    for m in history:
        if not all(np.isfinite(v) for v in m.values()) or set(m) != {"loss", "grad_norm", "epe_finest"}:
            raise AssertionError(f"train: bad chunk metrics {m}")
    # The mean loss of the last 10 steps is below that of the first 10. Every
    # step sees a fresh batch, so the chunk means also move with the batches'
    # difficulty (the size of their flows); ten more steps on one fixed batch,
    # the criterion of the JAX package's own trainer tests, must bring that
    # batch's loss down too.
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError("train: the mean loss of the last 10 steps is not below that of the first 10")
    net = T._trainable(trained, cfg, dev)
    fixed_step = T.make_train_step(net, T.make_optimizer(net.parameters(), 2e-4), "supervised")
    fixed = [float(fixed_step(batch)["loss"]) for _ in range(10)]
    _say("train: 10 more steps on one fixed batch, loss " + json.dumps(fixed))
    if not (all(np.isfinite(fixed)) and fixed[-1] < fixed[0]):
        raise AssertionError("train: ten steps on a fixed batch did not bring its loss down")
    del net, fixed_step

    # The photometric mode: five steps on that pair without its labels. Its
    # loss warps the second image at the finest level (8x48x64x3, unclipped)
    # through the kernel and sends the flow's gradient through the backward
    # kernel: one more launch of each a step.
    net = T._trainable(trained, cfg, dev)
    photo_step = T.make_train_step(net, T.make_optimizer(net.parameters(), 2e-4), "photometric")
    before = _all_launches()
    photo = [{k: float(v) for k, v in photo_step(pair).items()} for _ in range(5)]
    used = {k: n - before[k] for k, n in _all_launches().items()}
    _say("train: 5 photometric steps on one fixed pair: " + json.dumps({"steps": photo, "launches": used}))
    want_photo = {"cost_volume": 25, "bilinear_warp": 25, "vwarp": 0, "hwarp": 0,
                  "cost_volume_bwd": 25, "bilinear_warp_bwd": 25}
    if used != want_photo:
        raise AssertionError(f"5 photometric steps launched {used}, expected {want_photo}")
    if not all(np.isfinite(v) for m in photo for v in m.values()) or set(photo[0]) != {"loss", "grad_norm", "photo", "smooth"}:
        raise AssertionError(f"train: bad photometric metrics {photo}")
    if not photo[-1]["loss"] <= photo[0]["loss"] * 1.05:
        raise AssertionError("train: five photometric steps on a fixed pair raised its loss")
    del net, photo_step

    _step_breakdown(init, cfg, scenes, card)

    # bf16 from the same init and the same draws (the seed fixes both)
    kw16 = dict(steps=10, batch_size=_TRAIN_BATCH, hw=_TRAIN_HW, seed=0, scan_len=10, n_scenes=n_scenes,
                max_disp=max_disp, ckpt_dir=None)
    h16 = [_train_fast_logged(cfg=c, **kw16)[1][0] for c in (FlowConfig(compute_dtype="bfloat16"), cfg)]
    _say("train bf16 vs f32, 10 steps each (cosine over 10), mean metrics: " + json.dumps({"bfloat16": h16[0], "float32": h16[1]}))
    if not all(np.isfinite(v) for v in h16[0].values()):
        raise AssertionError("train: bf16 metrics are not finite")
    if abs(h16[0]["loss"] - h16[1]["loss"]) > 0.05 * h16[1]["loss"]:
        raise AssertionError("train: the bf16 loss is more than 5% from the f32 loss")

    # checkpoint round trip: the saved file holds the trained tensors bit for
    # bit and gives the same flow, to 0. cuDNN is held to its deterministic
    # algorithms for the comparison (the transposed convolutions' default one
    # adds with atomics: two runs on the same parameters differ in the last bit).
    loaded = params_from_jax(load_params(os.path.join(tmp, f"flow_{steps:06d}.msgpack")))
    loaded = {k: v.to(dev) for k, v in loaded.items()}
    if set(loaded) != set(trained) or not all(torch.equal(loaded[k], trained[k]) for k in trained):
        raise AssertionError("the saved checkpoint does not hold the trained parameters")
    loose = float((estimate_flow(trained, batch["im1"], batch["im2"], cfg)
                   - estimate_flow(trained, batch["im1"], batch["im2"], cfg)).abs().max())
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = estimate_flow(trained, batch["im1"], batch["im2"], cfg)
        b = estimate_flow(loaded, batch["im1"], batch["im2"], cfg)
    finally:
        torch.backends.cudnn.deterministic = was
    diff = float((a - b).abs().max())
    _say(f"checkpoint round trip: {len(loaded)} tensors equal bit for bit, flow on a fixed batch differs by {diff:g} "
         f"(must be 0; two runs on the same parameters without the deterministic flag: {loose:g})")
    if diff != 0.0 or not bool(torch.isfinite(a).all()):
        raise AssertionError("the saved checkpoint does not reproduce the trained network")

    # warm start from the trained checkpoint
    ckpt = {k: v.to(dev) for k, v in params_from_jax(load_params("ckpts/flow_086000.msgpack")).items()}
    before = T.eval_epe(ckpt, cfg, hw=_TRAIN_HW, max_disp=max_disp)
    warm = T.train_fast(cfg, steps=20, batch_size=_TRAIN_BATCH, hw=_TRAIN_HW, seed=1, params=ckpt, scan_len=10,
                        n_scenes=n_scenes, max_disp=max_disp, ckpt_dir=None)
    after = T.eval_epe(warm, cfg, hw=_TRAIN_HW, max_disp=max_disp)
    _say("warm start from flow_086000, 20 steps: " + json.dumps({
        "eval_epe_before_px": before, "eval_epe_after_px": after, "card": card}))
    if not (np.isfinite(before) and np.isfinite(after)):
        raise AssertionError("eval_epe is not finite")
    n, (h, w) = _TRAIN_BATCH, _TRAIN_HW
    return {"hw": _TRAIN_HW, "pairs": n, "dtype": torch.float32, "chunks": steps, "launches": launches,
            "image_warps": {(n, h, w, 3): 4 * steps}, "also_check": [(n, h // 4, w // 4, 3)]}


def eval_phase(card: str, tmp: str) -> dict:
    """The eval sweep on three synthetic clips, its resume, and the `eval`
    subcommand; returns the sweep's path for `kernel_phase`: six chunks of
    pairs and one render dispatch a clip, the dispatches by each clip's
    bucket, and the sweep's launches."""
    import vstab_torch
    from vstab_torch.eval.deepstab import _load_done, report_table, run_sweep, synthetic_clip_set

    path = os.path.join(tmp, "results.jsonl")
    t, h, w = shape = (48, 256, 320)
    kw = dict(n_synthetic=3, synth_shape=shape)
    recs, launches, dt = _run_counted("eval sweep", lambda: run_sweep(None, path, **kw))

    def check(recs, what):
        if [r["clip"] for r in recs] != ["synthetic_000", "synthetic_001", "synthetic_dyn_002"]:
            raise AssertionError(f"{what}: clips {[r['clip'] for r in recs]}")
        for r in recs:
            if not all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0 for k in ("stability", "cropping", "distortion")):
                raise AssertionError(f"{what}: bad scores {r}")
            if r["frames"] != 48:
                raise AssertionError(f"{what}: {r['frames']} frames")

    check(recs, "eval sweep")
    before = _all_launches()
    again = run_sweep(None, path, **kw)
    if again != recs or _all_launches() != before:
        raise AssertionError("eval sweep: the second call did not resume from the manifest")
    _say(report_table(recs))
    cfg = vstab_torch.Config()
    params = vstab_torch.default_params(cfg, ckpt_dir="ckpts")
    renders = {}
    for _, frames in synthetic_clip_set(3, t=t, h=h, w=w):
        d = _bucket(torch.from_numpy(frames).cuda(), params, cfg)[1]
        renders[d] = renders.get(d, 0) + 1
    _say("eval sweep: " + json.dumps({
        "clips": len(recs), "run_s": dt, "records": recs, "render_dispatches_by_bucket": renders, "card": card}))

    cli = os.path.join(tmp, "cli.jsonl")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vstab_torch", "eval", "--results", cli, "--n-synthetic", "3",
         "--synth-shape", "48", "256", "320"],
        capture_output=True, text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    if r.returncode != 0:
        raise AssertionError(f"the eval subcommand failed ({r.returncode}):\n{r.stderr[-3000:]}")
    agg = json.loads(r.stdout.strip().splitlines()[-1])["aggregate"]
    from_cli = sorted(_load_done(cli).values(), key=lambda rec: rec["clip"])
    check(from_cli, "eval subcommand")
    _say("eval subcommand: " + json.dumps({"aggregate": agg, "subprocess_s": time.perf_counter() - t0, "card": card}))
    for a, b in zip(recs, from_cli):
        if any(abs(a[k] - b[k]) > 0.02 for k in ("stability", "cropping", "distortion")):
            raise AssertionError(f"eval subcommand: scores of {a['clip']} differ from the library call's")
    return {"hw": (h, w), "n": t, "renders": renders, "chunks": len(recs) * _flow_chunks(t - 1), "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from vstab_torch.bench import card as card_line

    card = card_line()
    _say(card)
    _say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    name = torch.cuda.get_device_name(0)
    hbm = _hbm_rate(name)

    have_cv2 = importlib.util.find_spec("cv2") is not None
    _say(f"cv2 (OpenCV) installed: {have_cv2}")

    from vstab_torch.eval.synthetic import make_shaky_clip
    from vstab_torch.kernels import _build

    _say(f"kernel build: {_build.build_all():.1f} s ({', '.join(_build.SOURCES)})")
    paths = {}
    paths[_MAIN], device_ms, frames_np, frames, params = main_path(card)
    paths["affine_720p"] = affine_phase(frames, params, card)
    paths["batch_720p"] = batch_phase(frames, params, card)
    del frames
    torch.cuda.empty_cache()
    paths.update(sharded_phase(frames_np, params, card))
    torch.cuda.empty_cache()

    # 95 frames of 720p without another synthesis: the clip played forward,
    # then backward (the motion stays continuous), at uint8 levels.
    u8 = np.clip(np.concatenate([frames_np, frames_np[-2::-1]]) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    del frames_np
    paths["blocked_720p"] = blocked_phase("blocked 720p", u8, params, 32, card)
    t0 = time.perf_counter()
    hd, _ = make_shaky_clip(t=17, h=1080, w=1920, seed=1)
    hd8 = np.clip(np.concatenate([hd, hd[-2::-1]]) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    del hd
    _say(f"clip: {hd8.shape} (17 frames forward, then backward) synthesized in {time.perf_counter() - t0:.1f} s")
    paths["blocked_1080p"] = blocked_phase("blocked 1080p", hd8, params, 16, card)
    del hd8
    render_memory_probe(card)
    file_phase(u8[:33], have_cv2, card)
    del u8

    small_clip_check()
    schur_check()
    tmp = tempfile.mkdtemp(prefix="vstab_smoke_train_")
    try:
        paths["train_192x256"] = train_phase(card, tmp)
        paths["eval_256x320"] = eval_phase(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # Every path has run: each kernel against its plain version at the shapes
    # and dtypes those runs gave it, and each path's launches held to them.
    t0 = time.perf_counter()
    rows, per_shape, floor_ms = kernel_phase(hbm, paths)
    _say(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    device_time_line(per_shape, device_ms, floor_ms)
    t0 = time.perf_counter()
    bwd_rows, _ = backward_kernel_phase(hbm)
    _say(f"backward kernel checks: {time.perf_counter() - t0:.1f} s")
    rows.update(bwd_rows)
    by_path = {name: {**{k: 0 for k in _all_launches()}, **p["launches"]} for name, p in paths.items()}

    meta = {
        "cost_volume": ("vstab_torch/kernels/csrc/cost_volume.cu", "vstab/kernels/cost_volume.py:192"),
        "bilinear_warp": ("vstab_torch/kernels/csrc/warp.cu", "vstab/kernels/warp.py:263"),
        "vwarp": ("vstab_torch/kernels/csrc/warp1d.cu", "vstab/kernels/warp1d.py:267"),
        "hwarp": ("vstab_torch/kernels/csrc/warp1d.cu", "vstab/kernels/warp1d.py:356"),
        # No TPU kernel behind these two: the JAX trainer differentiates the
        # XLA formulations named here.
        "cost_volume_bwd": ("vstab_torch/kernels/csrc/cost_volume.cu", "vstab/kernels/cost_volume.py:52"),
        "bilinear_warp_bwd": ("vstab_torch/kernels/csrc/warp.cu", "vstab/kernels/warp.py:71"),
    }
    # The forward kernels report the whole-clip path's launches, the backward
    # kernels the training run's (no serving path launches them).
    main_of = {k: "train_192x256" if k.endswith("_bwd") else _MAIN for k in meta}
    kernels = [
        {
            "name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
            "launches": by_path[main_of[k]][k],
            "launches_by_path": {name: p[k] for name, p in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        for k, r in rows.items()
    ]
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
