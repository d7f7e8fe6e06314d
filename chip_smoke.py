#!/usr/bin/env python3
"""Drive the vstab_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, `nvcc`
and the repository's `ckpts/`. In order it:

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
   banded solve on the card.

Before its last line it prints `{"kernels": [...]}`, one entry per kernel;
its last line is `{"ok": true, "device": {...}}`. Any failed check raises,
and the script then exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
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

# Shapes the main path gives the cost volume: 8 frame pairs a chunk, the
# pyramid levels estimated for a 720-row clip padded to 768, finest first.
_CV_SHAPES = ((8, 192, 320, 32), (8, 96, 160, 64), (8, 48, 80, 96), (8, 24, 40, 128), (8, 12, 20, 196))
_CV_F32_SHAPE = (8, 48, 80, 96)  # compute_dtype="float32" at the middle level
# Shapes it gives the feature warp: every level but the coarsest.
_WARP_SHAPES = _CV_SHAPES[:4]
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


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


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


def kernel_phase(hbm: float, d_main: int, launches: dict):
    """Checks and times every kernel; returns (rows, per_shape, floor_ms):
    the one row per kernel of the `{"kernels": ...}` line, timed at the
    kernel's largest main-path shape, every (kernel, shape) row with its
    launches a run, and the time this timing gives a near-empty launch."""
    from vstab_torch.kernels import (
        bilinear_warp, bilinear_warp_plain, cost_volume, cost_volume_plain,
        hwarp, hwarp_plain, vwarp, vwarp_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    per_shape, rows = [], {}

    # -- cost volume, r=4: bf16 at the five levels of a 720p chunk (tensor
    # cores; useful operations 2*81*C a pixel) and one f32 shape (CUDA cores).
    # The forward pass launches it once a level for every chunk of pairs.
    if launches["cost_volume"] % len(_CV_SHAPES):
        raise AssertionError(f"cost_volume launches {launches['cost_volume']} are not a multiple of the levels")
    per_level = launches["cost_volume"] // len(_CV_SHAPES)
    tiny = torch.zeros((1, 2, 8, 8), device="cuda", dtype=torch.bfloat16)
    floor_ms = _time_ms(lambda: cost_volume(tiny, tiny, 4))
    _say(f"  launch floor: {floor_ms:.4f} ms "
         "(cost_volume on 1x2x8x8 bf16, timed like every kernel: no kernel's time can be below it)")
    for shape, dtype in [(s, torch.bfloat16) for s in _CV_SHAPES] + [(_CV_F32_SHAPE, torch.float32)]:
        f1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
        f2 = torch.randn(shape, generator=g, device="cuda").to(dtype)
        n, h, w, c = shape
        size = f1.element_size()
        bf16 = dtype == torch.bfloat16
        row = dict(
            kernel="cost_volume", shape=list(shape) + [str(dtype).split(".")[1], "r=4"],
            launches=per_level if bf16 else 0,
            max_abs_err=_check(f"cost_volume {shape} {dtype}", cost_volume(f1, f2, 4), cost_volume_plain(f1, f2, 4)),
            ms=_time_ms(lambda: cost_volume(f1, f2, 4)),
            plain_ms=_time_ms(lambda: cost_volume_plain(f1, f2, 4), iters=5),
            bytes=(2 * f1.numel() + n * h * w * 81) * size, flops=n * h * w * 81 * c * 2,
            rate=_BF16_RATE if bf16 else _F32_RATE, library_ms=None,
        )
        per_shape.append(row)
        del f1, f2

    # -- feature warp: the forward pass warps f2 at every level but the
    # coarsest, once a level for every chunk of pairs, so its launches are
    # four shapes the same number of times each. bf16 image and flow, the
    # flow up to +-12 px so that the kernel's +-8 clip matters; the plain
    # version gets the clipped flow. All four go to the vector kernel.
    if launches["bilinear_warp"] % len(_WARP_SHAPES):
        raise AssertionError(f"bilinear_warp launches {launches['bilinear_warp']} are not a multiple of the levels")
    for shape in _WARP_SHAPES:
        n, h, w, c = shape
        img = torch.randn(shape, generator=g, device="cuda").bfloat16()
        flow = (torch.rand((n, h, w, 2), generator=g, device="cuda") * 24 - 12).bfloat16()
        clipped = flow.clamp(-8, 8)
        img_nchw = img.permute(0, 3, 1, 2)
        grid = _grid(h, w, clipped[..., 0].float(), clipped[..., 1].float(), torch.bfloat16)
        per_shape.append(dict(
            kernel="bilinear_warp", shape=list(shape) + ["bfloat16", "bfloat16 flow to +-12"],
            launches=launches["bilinear_warp"] // len(_WARP_SHAPES),
            max_abs_err=_check(f"bilinear_warp {shape}", bilinear_warp(img, flow, 8), bilinear_warp_plain(img, clipped)),
            ms=_time_ms(lambda: bilinear_warp(img, flow, 8)),
            plain_ms=_time_ms(lambda: bilinear_warp_plain(img, clipped)),
            bytes=2 * img.numel() * 2 + flow.numel() * 2, flops=None,
            library_ms=_time_ms(lambda: F.grid_sample(
                img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)),
        ))
        del img, flow, clipped, img_nchw, grid
    # Checked, not timed: the vector kernel in f32 (C=8: two vectors a pixel,
    # the runtime count) and the element kernel (C=3).
    for shape, dtype in (((2, 48, 80, 8), torch.float32), ((2, 48, 80, 3), torch.bfloat16)):
        img = torch.randn(shape, generator=g, device="cuda").to(dtype)
        flow = (torch.rand(shape[:3] + (2,), generator=g, device="cuda") * 24 - 12).to(dtype)
        err = _check(f"bilinear_warp {shape} {dtype}", bilinear_warp(img, flow, 8), bilinear_warp_plain(img, flow.clamp(-8, 8)))
        per_shape[-1]["max_abs_err"] = max(per_shape[-1]["max_abs_err"], err)

    # -- 1D render warps, f32, at the padded render width 1280 + 2(d+1): the
    # buckets 16, 63 and 127 and the main path's bucket d_main, with 3 channels
    # (the frame) and 1 (the fields that hwarp resamples). At d=16 the rows of
    # 1314 floats do not start 16-byte aligned, so hwarp's 4-byte head and
    # tail copies run. The rows are timed at d_main: vwarp and hwarp run once
    # a render on the frame, hwarp the other times on a field. Two kinds of
    # field: "random" draws every pixel in +-1.2 d, so neighbouring pixels tap
    # unrelated rows; "smooth" is what the main path gives the warps, a 12x16
    # grid of vertices a frame (drawn in +-d) upsampled to the frame as
    # grid_to_flow upsamples the solved path. hwarp stages its row whole and
    # takes the same time on both; vwarp gathers from device memory, so its
    # main-path row is the smooth one and the random one launches 0 times.
    def field(shape, d, kind="random"):
        if kind == "random":
            return (torch.rand(shape, generator=g, device="cuda") * 2.4 * d - 1.2 * d).contiguous()
        coarse = (torch.rand((shape[0], 1, 12, 16), generator=g, device="cuda") * 2 - 1) * d
        return F.interpolate(coarse, size=shape[1:], mode="bilinear", align_corners=False)[:, 0].contiguous()

    def width(d):
        return 1280 + 2 * (d + 1)

    cases = {(d, c) for d in (16, 63, 127, d_main) for c in (1, 3)}
    errs = {"vwarp": [], "hwarp": []}
    for d, c in sorted(cases):
        shape = (48, 720, width(d), c)
        x = torch.rand(shape, generator=g, device="cuda")
        f = field(shape[:3], d)
        for mode in ("edge", "wrap"):
            errs["vwarp"].append(_check(f"vwarp {shape} d={d} {mode}", vwarp(x, f, d, mode), vwarp_plain(x, f, d, mode)))
            errs["hwarp"].append(_check(f"hwarp {shape} d={d} {mode}", hwarp(x, f, d, mode), hwarp_plain(x, f, d, mode)))
        del x, f
    for name, kern, plain, mode, c, kind, count in (
        ("vwarp", vwarp, vwarp_plain, "wrap", 3, "smooth", launches["vwarp"]),
        ("vwarp", vwarp, vwarp_plain, "wrap", 3, "random", 0),
        ("hwarp", hwarp, hwarp_plain, "edge", 3, "random", 1),
        ("hwarp", hwarp, hwarp_plain, "edge", 1, "random", launches["hwarp"] - 1),
    ):
        shape = (48, 720, width(d_main), c)
        x = torch.rand(shape, generator=g, device="cuda")
        f = field(shape[:3], d_main, kind)
        if kind == "smooth":
            for m in ("edge", "wrap"):
                errs[name].append(_check(f"{name} {shape} d={d_main} {m} smooth field", kern(x, f, d_main, m), plain(x, f, d_main, m)))
        fc = f.clamp(-d_main, d_main)
        zero = torch.zeros_like(fc)
        u, v = (zero, fc) if name == "vwarp" else (fc, zero)
        x_nchw = x.permute(0, 3, 1, 2)
        grid = _grid(*shape[1:3], u, v, torch.float32)
        row = dict(
            kernel=name, shape=list(shape) + [f"d={d_main} {mode}"], field=kind, launches=count,
            max_abs_err=max(errs[name]),
            ms=_time_ms(lambda: kern(x, f, d_main, mode)),
            plain_ms=_time_ms(lambda: plain(x, f, d_main, mode), iters=5),
            bytes=4 * (2 * x.numel() + f.numel()), flops=None,
            # border padding: grid_sample has no wrap mode
            library_ms=_time_ms(lambda: F.grid_sample(
                x_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)),
        )
        per_shape.append(row)
        if name == "hwarp" and c == 3:
            fs = field(shape[:3], d_main, "smooth")
            errs[name].append(_check(f"hwarp {shape} d={d_main} {mode} smooth field", hwarp(x, fs, d_main, mode), hwarp_plain(x, fs, d_main, mode)))
            _say(f"  hwarp {shape} on the smooth field: {_time_ms(lambda: hwarp(x, fs, d_main, mode)):.4f} ms "
                 f"(random field: {row['ms']:.4f} ms)")
            del fs
        del x, f, fc, zero, u, v, grid
    for row in per_shape:
        _bound(row, hbm)
        _say(f"  kernel {json.dumps(row)}")
        # A kernel's first row is its largest main-path shape (for vwarp on
        # the main path's kind of field); its error is the largest over all
        # its shapes.
        first = rows.setdefault(row["kernel"], dict(row))
        first["max_abs_err"] = max(first["max_abs_err"], row["max_abs_err"])
    return rows, per_shape, floor_ms


def device_time_line(per_shape, device_ms, floor_ms) -> None:
    """For each kernel, the sum over its shapes of launches x ms (timed alone,
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
        out[name] = {
            "sum_launches_x_ms": sum(r["launches"] * r["ms"] for r in per_shape if r["kernel"] == name),
            "sum_launches_x_ms_less_floor": sum(
                r["launches"] * (r["ms"] - floor_ms) for r in per_shape if r["kernel"] == name),
            "profiler_ms": sum(ms for k, (ms, _) in device_ms.items() if key in k),
            "profiler_launches": sum(n for k, (_, n) in device_ms.items() if key in k),
        }
        if out[name]["profiler_launches"] == 0:
            raise AssertionError(f"the profiler saw no device function of {name} ({key!r})")
    _say("kernel device time per run: " + json.dumps(out))


def main_path():
    import vstab_torch
    from vstab_torch.eval.synthetic import make_shaky_clip
    from vstab_torch.kernels import KERNELS, reset_launches
    from vstab_torch.pipeline import _params_match, clip_flow, smooth_paths
    from vstab_torch.render.render import (
        grid_to_flow, pick_max_disp, render_stabilized, residual_disp_bound,
    )

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

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, diags = vstab_torch.stabilize(frames, params, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in KERNELS.items()}
    _say(f"main path: first run {first_s:.2f} s, launches {json.dumps(launches)}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if tuple(out.shape) != (48, 720, 1280, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad output: shape {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    valid = float((out != 0).any(dim=-1).float().mean())
    _say(f"output: {tuple(out.shape)} finite, non-border pixels {valid:.4f}")
    del out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = vstab_torch.stabilize(frames, params, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del out

    h, w = 720, 1280
    stage = {}
    t0 = time.perf_counter()
    flow = clip_flow(params, frames, cfg)
    torch.cuda.synchronize()
    stage["flow_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    path, _ = smooth_paths(flow, cfg, (h, w))
    bound = residual_disp_bound(path.cpu().numpy(), h, w, cfg.smooth.method)
    d = pick_max_disp(bound, cfg.render)
    torch.cuda.synchronize()
    stage["smooth_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with torch.inference_mode():
        render_stabilized(frames, grid_to_flow(path, h, w), cfg.render, max_disp=d)
    torch.cuda.synchronize()
    stage["render_ms"] = (time.perf_counter() - t0) * 1e3
    _say("main path: " + json.dumps({
        "frames_per_s": 48 / dt, "run_s": dt, **stage, "residual_bound_px": bound, "max_disp": d,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }))
    device_ms = profile(lambda: vstab_torch.stabilize(frames, params, cfg))
    return launches, d, device_ms


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


def small_clip_check():
    """The card's output vs the CPU run of the plain versions, f32 flow."""
    import vstab_torch
    from vstab_torch.eval.synthetic import make_shaky_clip

    base = vstab_torch.Config()
    cfg = dataclasses.replace(base, flow=dataclasses.replace(base.flow, compute_dtype="float32"))
    frames, _ = make_shaky_clip(t=9, h=64, w=96, seed=0)
    params = vstab_torch.default_params(cfg, ckpt_dir="ckpts", device="cpu")
    want, _ = vstab_torch.stabilize(frames, params, cfg, device="cpu")
    got, _ = vstab_torch.stabilize(frames, params, cfg)
    err = (got.cpu() - want).abs()
    share = float((err <= 1e-3).float().mean())
    _say(f"small clip (9x64x96, f32): card vs CPU plain max_abs_err {float(err.max()):.3e}, "
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
    card = _card()
    _say(card)
    _say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    name = torch.cuda.get_device_name(0)
    hbm = _hbm_rate(name)

    from vstab_torch.kernels import _build

    _say(f"kernel build: {_build.build_all():.1f} s ({', '.join(_build.SOURCES)})")
    launches, d_main, device_ms = main_path()
    t0 = time.perf_counter()
    rows, per_shape, floor_ms = kernel_phase(hbm, d_main, launches)
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
            "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
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
