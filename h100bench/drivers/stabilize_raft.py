"""Whole clips through `vstab_torch.stabilize` with RAFT as the flow
network, back to back in a closed loop with one caller, cycling through a
pool of clips already on the card: `drivers/stabilize.py`'s loop, checks and
trace, with RAFT's weights drawn from the configuration's seed.

End to end: frames_per_s and clip_p90_ms, as in `drivers/stabilize.py`.
Judged: `check_clips` clips of the window, a uniform sample drawn from the
seed, against `reference/raft.py`'s flow under `reference/stabilize.py`'s
vertex motion, smoothing, bucket and render (`judge.stabilizer_readings`).
Traced run: after the window, `trace_clips` clips split into flow, smooth
and render between synchronisations, and `trace_clips` clips of `stabilize`
under the profiler, with the program's spans and every kernel launch
recorded: the correlation lookup's launches counted by `counts/raft.py`,
the other kernels' by `counts/kernels.py`.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from h100bench import harness, judge, trace_read
from h100bench.counts import kernels as kernel_counts
from h100bench.counts import raft as raft_counts
from h100bench.drivers import common
from h100bench.drivers.stabilize import program_outputs
from h100bench.reference import precision
from h100bench.reference import raft as ref_raft
from h100bench.reference import stabilize as ref

LOOKUP = "vstab_corr_lookup"
LOOKUP_KERNELS = ("corr_lookup_",)  # its name prefix in the profiler's trace


def params(run: harness.Run) -> Dict[str, torch.Tensor]:
    """RAFT's weights drawn by the harness from the configuration's seed,
    float32 on the device (a test may pass its own)."""
    if run.params is not None:
        return {k: v.to(run.device) for k, v in run.params.items()}
    w = run.cell.config["weights"]
    if w["init"] != "raft":
        raise ValueError(f"{run.cell.name}: weights {w} are not RAFT's initialisers")
    flow = run.cell.config["program"]["flow"]
    return ref_raft.init_params(w["seed"], run.device, flow["corr_levels"], flow["corr_radius"])


def reference_outputs(frames: torch.Tensor, p, cfg_dict: Dict, policy: str,
                      corr_bf16: bool = False) -> Dict:
    """The reference's clip under `policy` ('frames' rendered lazily)."""
    with precision.tf32(policy == "tf32"):
        solved = ref_raft.solve(frames, p, cfg_dict, policy, corr_bf16)
    solved["frames"] = ref.render_blocks(frames, solved, cfg_dict, frames.device)
    return solved


def readings(cand: Dict, frames: torch.Tensor, p, cfg_dict: Dict) -> Dict[str, float]:
    ref_out = reference_outputs(frames, p, cfg_dict, "f32")
    with precision.tf32(False):
        return judge.stabilizer_readings(cand, ref_out)


def profiled(run_fn: Callable[[], None]) -> Optional[Dict]:
    """`run_fn` once under the profiler, every kernel launch recorded: the
    trace's summary plus 'lookup_bound_s' / 'lookup_device_s' (the lookup
    launches' least time, and the profiler's time of the lookup kernel),
    'kernel_bound_s' / 'kernel_device_s' (the same for the other kernels of
    the port), the launches and their events; None without device events."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="h100bench_trace_")
    os.close(fd)
    try:
        with common.recorded_launches() as calls:
            trace_read.record(run_fn, path)
        summary = trace_read.summarize(path)
    finally:
        os.remove(path)
    if summary is None:
        return None
    by_name = summary.pop("by_name")

    def device(prefixes):
        hits = [v for name, v in by_name.items() if any(k in name for k in prefixes)]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    lookups = [a for s, a in calls if s == LOOKUP]
    summary["lookup_bound_s"] = sum(raft_counts.lookup_bound_s(a) for a in lookups)
    summary["lookup_launches"] = len(lookups)
    summary["lookup_device_s"], summary["lookup_events"] = device(LOOKUP_KERNELS)
    summary["kernel_bound_s"] = sum(kernel_counts.bound_s(s, a) for s, a in calls if s != LOOKUP)
    summary["kernel_device_s"], port_events = device(common.PORT_KERNELS)
    summary["kernel_launches"] = len(calls) - len(lookups)
    summary["kernel_events"] = port_events
    return summary


def run(run: harness.Run) -> harness.Outcome:
    from vstab_torch.flow import raft  # noqa: F401  (a program without RAFT stops here)

    import vstab_torch
    from vstab_torch.pipeline import clip_flow, path_to_flow, render_bucket, smooth_paths
    from vstab_torch.render.render import render_stabilized

    dev, spec, mix = run.device, run.cell.spec, run.cell.traffic
    cfg_dict = run.cell.config["program"]
    cfg = common.program_config(run.cell.config)
    p = params(run)
    common.build(dev)
    pool = harness.generator(mix["generator"]).generate(mix, run.seed, dev)["clips"]
    t, h, w, _ = pool[0].shape
    vstab_torch.stabilize(pool[0], p, cfg, device=dev)  # warm-up: the cell's one shape
    common.sync(dev)
    setup_s = harness.elapsed(run.t_start)
    run.say(f"set-up {setup_s:.3f} s: {len(pool)} clips of {t}x{h}x{w}")

    times: List[float] = []
    sample = judge.Reservoir(spec["check_clips"], run.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    while True:
        i = len(times)
        c0 = time.perf_counter()
        out, diags = vstab_torch.stabilize(pool[i % len(pool)], p, cfg, device=dev)
        common.sync(dev)
        c1 = time.perf_counter()
        times.append(c1 - c0)
        sample.offer((i % len(pool), out, diags))
        del out, diags
        if c1 - t0 >= run.seconds:
            break
    window_s = c1 - t0
    n = len(times)
    e2e = {
        "frames_per_s": n * t / window_s,
        "clip_p90_ms": statistics.quantiles(times, n=10)[8] * 1e3 if n >= 2 else times[0] * 1e3,
        "setup_s": setup_s,
    }
    run.say(f"window {window_s:.3f} s: {n} clips, {e2e['frames_per_s']:.3f} frames/s, "
            f"clip median {statistics.median(times) * 1e3:.3f} ms, p90 {e2e['clip_p90_ms']:.3f} ms")

    trace = None
    if run.trace:
        spans: Dict[str, List[float]] = {}

        def flow(st):
            st["flow"] = clip_flow(p, st["frames"], cfg)

        def smooth(st):
            st["path"], _ = smooth_paths(st["flow"], cfg, (h, w))
            st["bound"], st["bucket"] = render_bucket(st["path"], cfg, (h, w))

        def render(st):
            st["out"] = render_stabilized(st["frames"], path_to_flow(st["path"], cfg, (h, w)),
                                          cfg.render, max_disp=st["bucket"])

        stages = {"flow": flow, "smooth": smooth, "render": render}
        with torch.inference_mode():
            for k in range(spec["trace_clips"]):
                st = {"frames": pool[k % len(pool)]}
                common.timed_stages(dev, stages, spans, st)
                run.say(f"clip {k % len(pool)}: bound {st['bound']:.3f} px, bucket {st['bucket']}")

        def traced():
            for k in range(spec["trace_clips"]):
                vstab_torch.stabilize(pool[k % len(pool)], p, cfg, device=dev)

        ops = raft_counts.clip_ops(t, h, w, cfg_dict["flow"])
        least = raft_counts.least_s(ops)
        trace = {
            "spans": spans,
            "profile": profiled(traced) if dev.type == "cuda" else None,
            # flops over an effective peak: readers.mfu then reads the
            # window's least time at the peaks of the dtypes over its seconds
            "window": {"seconds": window_s, "flops": n * sum(ops.values()),
                       "peak_flops": sum(ops.values()) / least},
        }
        run.say(f"clip ops {ops}, least {least * 1e3:.3f} ms; "
                f"spans {({k: [round(s * 1e3, 3) for s in v] for k, v in spans.items()})}")
        run.say(f"power limit: {harness.power_limit()}")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    judged = []
    for idx, out, diags in sample.items:
        judged.append(readings(program_outputs(out, diags), pool[idx], p, cfg_dict))
        run.say(f"readings of clip {idx}: {judged[-1]}")
    checks = judge.run_checks(judged, spec["limits"])
    return harness.Outcome(e2e=e2e, attempted=n, failed=0, checks=checks,
                           memory_peak_bytes=int(peak), trace=trace)
