#!/usr/bin/env python3
"""Drive the vstab_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, `nvcc`
and the repository's `ckpts/`. It does the following (step 4 runs after
step 11, once every path has shown its shapes and buckets):

1. prints the card (`nvidia-smi` name and power limit) and the torch and
   CUDA versions; exits non-zero when torch sees no CUDA device;
2. builds the four hand-written kernels from `vstab_torch/kernels/csrc/`
   (one `nvcc` per source, in parallel) and prints the build time;
3. runs the main path: `default_params` reads `ckpts/flow_086000.msgpack`
   with the port's own reader, then `stabilize` runs on the 48x720x1280
   synthetic clip (`make_shaky_clip(t=48, h=720, w=1280, seed=0)`, the input
   of `bench.py`) with bf16 flow. Launch counters are zeroed just before and
   read just after; every kernel must have launched. A second, timed run
   gives frames/s; a third gives the flow / smooth / render times; a fourth
   runs under torch.profiler for device time by kernel;
4. holds each kernel against its plain torch version on the card, at the
   shapes the main path gives it (the cost volume at its five pyramid levels
   in bf16 and one f32 shape; the feature warp at the four levels it runs
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
   to its chunks of frame pairs and its render dispatches. Then the peak
   device memory of one 64-frame 1080p uint8 render dispatch;
11. file to file, where the machine has OpenCV (`cv2`; read once at the start
   and printed): writes a short 720p file and runs `python -m vstab_torch
   stabilize ... --blocked --block-len 16` as a subprocess, then checks its
   record and the output's frame count. Without `cv2` it says that this step
   was not run.

Every path of steps 3 and 7 to 10 is driven with the launch counters zeroed
just before and read just after, and must have launched all four kernels.

Before its last line it prints `{"kernels": [...]}`, one entry per kernel;
its last line is `{"ok": true, "device": {...}}`. Any failed check raises,
and the script then exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
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


_CV_F32_SHAPE = (8, 48, 80, 96)  # compute_dtype="float32" at the middle level
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
    """Checks and times every kernel at the shapes of every path in `paths`
    (name -> {"hw", "n" frames a render dispatch, "d" the bucket, "chunks" of
    frame pairs the flow ran on, render "dispatches", "launches" of one run);
    returns (rows, per_shape, floor_ms): the one row per kernel
    of the `{"kernels": ...}` line, timed at the kernel's largest shape on the
    whole-clip path, every (kernel, shape, path) row with its launches a run,
    and the time this timing gives a near-empty launch."""
    from vstab_torch.kernels import (
        bilinear_warp, bilinear_warp_plain, cost_volume, cost_volume_plain,
        hwarp, hwarp_plain, vwarp, vwarp_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    per_shape, rows = [], {}
    tiny = torch.zeros((1, 2, 8, 8), device="cuda", dtype=torch.bfloat16)
    floor_ms = _time_ms(lambda: cost_volume(tiny, tiny, 4))
    _say(f"  launch floor: {floor_ms:.4f} ms "
         "(cost_volume on 1x2x8x8 bf16, timed like every kernel: no kernel's time can be below it)")

    def per_level(path, kernel, levels):
        """Launches of a flow kernel at each of its levels: one a chunk of pairs."""
        n, chunks = paths[path]["launches"][kernel], paths[path]["chunks"]
        if n != levels * chunks:
            raise AssertionError(
                f"{path}: {kernel} launched {n} times, not once a level ({levels}) for each of {chunks} chunks")
        return chunks

    # -- cost volume, r=4: bf16 at the five levels of a chunk of 8 pairs
    # (tensor cores; useful operations 2*81*C a pixel) and, for the whole-clip
    # path, one f32 shape (CUDA cores). The forward pass launches it once a
    # level for every chunk of pairs. Every path gets its own rows, also where
    # its frame size is one already shown: its launches belong to its shapes.
    def cv_rows(path, f32_too):
        shapes = _level_shapes(*paths[path]["hw"])
        count = per_level(path, "cost_volume", len(shapes))
        cases = [(s, torch.bfloat16) for s in shapes] + ([(_CV_F32_SHAPE, torch.float32)] if f32_too else [])
        for shape, dtype in cases:
            f1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
            f2 = torch.randn(shape, generator=g, device="cuda").to(dtype)
            n, h, w, c = shape
            size = f1.element_size()
            bf16 = dtype == torch.bfloat16
            per_shape.append(dict(
                kernel="cost_volume", path=path, shape=list(shape) + [str(dtype).split(".")[1], "r=4"],
                launches=count if bf16 else 0,
                max_abs_err=_check(f"cost_volume {shape} {dtype}", cost_volume(f1, f2, 4), cost_volume_plain(f1, f2, 4)),
                ms=_time_ms(lambda: cost_volume(f1, f2, 4)),
                plain_ms=_time_ms(lambda: cost_volume_plain(f1, f2, 4), iters=5),
                bytes=(2 * f1.numel() + n * h * w * 81) * size, flops=n * h * w * 81 * c * 2,
                rate=_BF16_RATE if bf16 else _F32_RATE, library_ms=None,
            ))
            del f1, f2

    # -- feature warp: the forward pass warps f2 at every level but the
    # coarsest, once a level for every chunk of pairs, so its launches are
    # four shapes the same number of times each. bf16 image and flow, the
    # flow up to +-12 px so that the kernel's +-8 clip matters; the plain
    # version gets the clipped flow. All four go to the vector kernel.
    def warp_rows(path):
        shapes = _level_shapes(*paths[path]["hw"])[:4]
        count = per_level(path, "bilinear_warp", len(shapes))
        for shape in shapes:
            n, h, w, c = shape
            img = torch.randn(shape, generator=g, device="cuda").bfloat16()
            flow = (torch.rand((n, h, w, 2), generator=g, device="cuda") * 24 - 12).bfloat16()
            clipped = flow.clamp(-8, 8)
            img_nchw = img.permute(0, 3, 1, 2)
            grid = _grid(h, w, clipped[..., 0].float(), clipped[..., 1].float(), torch.bfloat16)
            per_shape.append(dict(
                kernel="bilinear_warp", path=path, shape=list(shape) + ["bfloat16", "bfloat16 flow to +-12"],
                launches=count,
                max_abs_err=_check(f"bilinear_warp {shape}", bilinear_warp(img, flow, 8), bilinear_warp_plain(img, clipped)),
                ms=_time_ms(lambda: bilinear_warp(img, flow, 8)),
                plain_ms=_time_ms(lambda: bilinear_warp_plain(img, clipped)),
                bytes=2 * img.numel() * 2 + flow.numel() * 2, flops=None,
                library_ms=_time_ms(lambda: F.grid_sample(
                    img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)),
            ))
            del img, flow, clipped, img_nchw, grid

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
    # frame, hwarp the other times on a field (two or three, by the bucket):
    # four rows a path (the random vwarp row only on the whole-clip path),
    # each checked in both modes on the field it is timed on.
    def render_rows(path):
        n, (h, w), d = paths[path]["n"], paths[path]["hw"], paths[path]["d"]
        launches = paths[path]["launches"]
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
        if launches["vwarp"] != paths[path]["dispatches"] or launches["hwarp"] % launches["vwarp"]:
            raise AssertionError(
                f"{path}: {paths[path]['dispatches']} render dispatches launched vwarp "
                f"{launches['vwarp']} and hwarp {launches['hwarp']} times")
        cases = [
            ("vwarp", vwarp, vwarp_plain, "wrap", 3, "smooth", launches["vwarp"]),
            ("vwarp", vwarp, vwarp_plain, "wrap", 3, "random", 0),
            ("hwarp", hwarp, hwarp_plain, "edge", 3, "random", launches["vwarp"]),
            ("hwarp", hwarp, hwarp_plain, "edge", 1, "random", launches["hwarp"] - launches["vwarp"]),
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
    # levels, and its render dispatches (block length, width and bucket).
    for path in [_MAIN] + [p for p in paths if p != _MAIN]:
        cv_rows(path, f32_too=path == _MAIN)
        warp_rows(path)
        if path == _MAIN:
            extra_warp_checks()
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
    path = {"hw": (720, 1280), "n": 48, "d": res["max_disp"], "chunks": _flow_chunks(47),
            "dispatches": 1, "launches": launches}
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
    return {"hw": (h, w), "n": t, "d": res["max_disp"], "chunks": _flow_chunks(t - 1),
            "dispatches": 1, "launches": launches}


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
    return {"hw": (h, w), "n": t, "d": d, "chunks": 2 * _flow_chunks(t - 1),
            "dispatches": 2, "launches": launches}


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
    return {"hw": (h, w), "n": min(block_len, t), "d": d, "chunks": blocks * _flow_chunks(block_len),
            "dispatches": blocks, "launches": launches}


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

    t0 = time.perf_counter()
    rows, per_shape, floor_ms = kernel_phase(hbm, paths)
    _say(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    device_time_line(per_shape, device_ms, floor_ms)
    small_clip_check()
    schur_check()

    meta = {
        "cost_volume": ("vstab_torch/kernels/csrc/cost_volume.cu", "vstab/kernels/cost_volume.py:192"),
        "bilinear_warp": ("vstab_torch/kernels/csrc/warp.cu", "vstab/kernels/warp.py:263"),
        "vwarp": ("vstab_torch/kernels/csrc/warp1d.cu", "vstab/kernels/warp1d.py:267"),
        "hwarp": ("vstab_torch/kernels/csrc/warp1d.cu", "vstab/kernels/warp1d.py:356"),
    }
    kernels = [
        {
            "name": k, "route": "cuda", "source": meta[k][0], "replaces": meta[k][1],
            "launches": paths[_MAIN]["launches"][k],
            "launches_by_path": {name: p["launches"][k] for name, p in paths.items()},
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
