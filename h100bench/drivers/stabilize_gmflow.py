"""Whole clips through `vstab_torch.stabilize` with GMFlow as the flow
network, back to back in a closed loop with one caller, cycling through a
pool of clips already on the card: `drivers/stabilize_raft.py`'s window,
checks and trace, with GMFlow's weights drawn from the configuration's seed.

End to end: frames_per_s and clip_p90_ms, as in `drivers/stabilize.py`.
Judged: `check_clips` clips of the window, a uniform sample drawn from the
seed, against `reference/gmflow.py`'s flow under `reference/stabilize.py`'s
vertex motion, smoothing, bucket and render (`judge.stabilizer_readings`).
Traced run: after the window, `trace_clips` clips split into flow, smooth
and render between synchronisations, and `trace_clips` clips of `stabilize`
under the profiler, with the program's spans and every kernel launch
recorded: the port's kernels (the cost volume of the local matching and
propagation, the render's warps) counted by `counts/kernels.py`; the
attention (the kernels launched inside `scaled_dot_product_attention`) and
every kernel launched inside the matching and propagation spans timed from
the trace, their least time from the spans' `attn_flops`, `match_flops` and
`prop_flops` (`counts/gmflow.py`).
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from h100bench import harness, judge, trace_read
from h100bench.counts import gmflow as gmflow_counts
from h100bench.counts import kernels as kernel_counts
from h100bench.drivers import common
from h100bench.drivers.stabilize import program_outputs
from h100bench.reference import gmflow as ref_gmflow
from h100bench.reference import precision
from h100bench.reference import stabilize as ref

SPAN = "vstab.flow.gmflow."
ATTENTION_OPS = ("scaled_dot_product",)  # host ops whose launches are the transformer's attention
MATCH_SPANS = (SPAN + "match", SPAN + "propagate")
# per-layer metric -> the spans whose stream ms it sums a chunk
CHUNK_SPANS = {"encode": ("encode",), "transformer": ("transformer",), "match": ("match", "propagate")}


SCALES = ("norm_gain", "feature_scale")  # the weights' conditioning, 1 as published


def params(run: harness.Run) -> Dict[str, torch.Tensor]:
    """GMFlow's weights drawn by the harness from the configuration's seed
    and scaled by its conditioning (`reference.gmflow.init_params`), float32
    on the device (a test may pass its own)."""
    if run.params is not None:
        return {k: v.to(run.device) for k, v in run.params.items()}
    w = run.cell.config["weights"]
    if w["init"] != "gmflow":
        raise ValueError(f"{run.cell.name}: weights {w} are not GMFlow's initialisers")
    return ref_gmflow.init_params(w["seed"], run.device, **{k: w.get(k, 1.0) for k in SCALES})


def reference_outputs(frames: torch.Tensor, p, cfg_dict: Dict, policy: str,
                      match_bf16: bool = False) -> Dict:
    """The reference's clip under `policy` ('frames' rendered lazily)."""
    with precision.tf32(policy == "tf32"):
        solved = ref_gmflow.solve(frames, p, cfg_dict, policy, match_bf16)
    solved["frames"] = ref.render_blocks(frames, solved, cfg_dict, frames.device)
    return solved


def readings(cand: Dict, frames: torch.Tensor, p, cfg_dict: Dict) -> Dict[str, float]:
    ref_out = reference_outputs(frames, p, cfg_dict, "f32")
    with precision.tf32(False):
        return judge.stabilizer_readings(cand, ref_out)


def _within(starts: Sequence[float], ends: Sequence[float], ts: float) -> bool:
    """Whether ts lies in one of the sorted, disjoint intervals [starts, ends]."""
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ends[i]


def attention_device_s(path: str) -> Tuple[float, int]:
    """(seconds, kernels) of the device time of the kernels launched inside
    a host op named like ATTENTION_OPS or inside a span of MATCH_SPANS, from
    a chrome trace of `trace_read.record`: each kernel found by the
    correlation id of its launch."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    intervals, launches, kernels = [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat"), e.get("name", "")
        if (cat == "cpu_op" and any(k in name for k in ATTENTION_OPS)) or (
                cat == trace_read.SPAN_CAT and name in MATCH_SPANS):
            intervals.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
        elif cat == "kernel" and "correlation" in e.get("args", {}):
            kernels.append((e["args"]["correlation"], float(e["dur"])))
    merged = trace_read._merge(intervals)
    starts, ends = [a for a, _ in merged], [b for _, b in merged]
    hits = [d for c, d in kernels if c in launches and _within(starts, ends, launches[c])]
    return sum(hits) / 1e6, len(hits)


def profiled(run_fn: Callable[[], None]) -> Optional[Dict]:
    """`run_fn` once under the profiler, every kernel launch and span
    recorded: the trace's summary plus 'kernel_bound_s' / 'kernel_device_s'
    (the port's kernels' least time, and the profiler's time of them),
    'attn_bound_s' / 'attn_device_s' (the attention's and matchings' least
    time from the spans, and the profiler's time of their kernels), the
    spans' stream ms a chunk ('chunk_ms'); None without device events."""
    from vstab_torch.utils import trace

    fd, path = tempfile.mkstemp(suffix=".json", prefix="h100bench_trace_")
    os.close(fd)
    trace.clear()
    try:
        with common.recorded_launches() as calls:
            trace_read.record(run_fn, path)
        summary = trace_read.summarize(path)
        attn_s, attn_kernels = attention_device_s(path)
    finally:
        os.remove(path)
    if summary is None:
        return None
    by_name = summary.pop("by_name")
    hits = [v for name, v in by_name.items() if any(k in name for k in common.PORT_KERNELS)]
    summary["kernel_bound_s"] = sum(kernel_counts.bound_s(s, a) for s, a in calls)
    summary["kernel_launches"] = len(calls)
    summary["kernel_device_s"] = sum(s for s, _ in hits)
    summary["kernel_events"] = sum(n for _, n in hits)
    records = [r for r in trace.records() if r["name"].startswith(SPAN)]
    attrs = [r["attrs"] for r in records]
    summary["attn_bound_s"] = gmflow_counts.attention_least_s(
        sum(a.get("attn_flops", 0.0) for a in attrs),
        sum(a.get("match_flops", 0.0) + a.get("prop_flops", 0.0) for a in attrs))
    summary["attn_device_s"], summary["attn_kernels"] = attn_s, attn_kernels
    summary["chunk_ms"] = chunk_ms(records)
    return summary


def chunk_ms(records: List[Dict]) -> Dict[str, List[float]]:
    """Per CHUNK_SPANS entry, the stream ms a chunk (`vstab.flow.chunk`, the
    spans' parent) of the spans it sums, over the chunks that ran them."""
    out: Dict[str, List[float]] = {}
    for metric, parts in CHUNK_SPANS.items():
        per: Dict[int, float] = {}
        for r in records:
            if r["name"].rpartition(".")[2] in parts and r["device_ms"] is not None:
                per[r["parent"]] = per.get(r["parent"], 0.0) + r["device_ms"]
        out[metric] = list(per.values())
    return out


def chunk_median_ms(ctx, metric: str) -> Optional[float]:
    """The per-layer reading: the median over the profiled chunks of `metric`'s stream ms."""
    ms = ((ctx or {}).get("profile") or {}).get("chunk_ms", {}).get(metric)
    return statistics.median(ms) if ms else None


def window(run: harness.Run, stabilize: Callable, pool: List[torch.Tensor]):
    """The timed window: clips of the pool back to back until `run.seconds`
    have passed (the last one finishes); (per-clip seconds, window seconds,
    the judged sample)."""
    times: List[float] = []
    sample = judge.Reservoir(run.cell.spec["check_clips"], run.seed)
    t0 = time.perf_counter()
    while True:
        i = len(times)
        c0 = time.perf_counter()
        out, diags = stabilize(pool[i % len(pool)])
        common.sync(run.device)
        c1 = time.perf_counter()
        times.append(c1 - c0)
        sample.offer((i % len(pool), out, diags))
        del out, diags
        if c1 - t0 >= run.seconds:
            return times, c1 - t0, sample


def run(run: harness.Run) -> harness.Outcome:
    from vstab_torch.flow import gmflow  # noqa: F401  (a program without GMFlow stops here)

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

    def stabilize(frames):
        return vstab_torch.stabilize(frames, p, cfg, device=dev)

    stabilize(pool[0])  # warm-up: the cell's one shape
    common.sync(dev)
    setup_s = harness.elapsed(run.t_start)
    run.say(f"set-up {setup_s:.3f} s: {len(pool)} clips of {t}x{h}x{w}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times, window_s, sample = window(run, stabilize, pool)
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
                stabilize(pool[k % len(pool)])

        ops = gmflow_counts.clip_ops(t, h, w)
        least = gmflow_counts.least_s(ops)
        prof = profiled(traced) if dev.type == "cuda" else None
        trace = {
            "spans": spans,
            "profile": prof,
            # flops over an effective peak: readers.mfu then reads the
            # window's least time at the peaks of the dtypes over its seconds
            "window": {"seconds": window_s, "flops": n * sum(ops.values()),
                       "peak_flops": sum(ops.values()) / least},
        }
        run.say(f"clip ops {ops}, least {least * 1e3:.3f} ms; "
                f"spans {({k: [round(s * 1e3, 3) for s in v] for k, v in spans.items()})}")
        if prof:
            run.say(f"attention: least {prof['attn_bound_s'] * 1e3:.3f} ms, device "
                    f"{prof['attn_device_s'] * 1e3:.3f} ms in {prof['attn_kernels']} kernels; chunk ms "
                    f"{({k: [round(s, 3) for s in v] for k, v in prof['chunk_ms'].items()})}")
        run.say(f"power limit: {harness.power_limit()}")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    judged = []
    for idx, out, diags in sample.items:
        judged.append(readings(program_outputs(out, diags), pool[idx], p, cfg_dict))
        run.say(f"readings of clip {idx}: {judged[-1]}")
    checks = judge.run_checks(judged, spec["limits"])
    return harness.Outcome(e2e=e2e, attempted=n, failed=0, checks=checks,
                           memory_peak_bytes=int(peak), trace=trace)
