"""Whole clips through `vstab_torch.stabilize`, back to back in a closed loop
with one caller, cycling through a pool of clips already on the card.

End to end: frames_per_s (all frames of all clips over the whole window;
the clip in flight when the seconds run out finishes and counts with its
time) and clip_p90_ms (the 90th percentile of every clip's wall time, call
to result). Judged: `check_clips` clips of the window, a uniform sample
drawn from the seed, against the reference (`judge.stabilizer_readings`).
Traced run: after the window, `trace_clips` clips split into flow, smooth
and render between synchronisations, and `trace_clips` clips of
`stabilize` under the profiler.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from h100bench import harness, judge
from h100bench.counts import PEAK_FLOPS
from h100bench.counts import pwcnet as flops
from h100bench.drivers import common
from h100bench.reference import precision
from h100bench.reference import stabilize as ref


def program_outputs(out: torch.Tensor, diags: Dict) -> Dict:
    """The program's clip as the judge reads it."""
    return {"profiles": diags["profiles"], "disp": diags["profiles"] - diags["smoothed"],
            "frames": judge.blocks_of(out, 16, out.device)}


def reference_outputs(frames: torch.Tensor, params, cfg_dict: Dict, policy: str) -> Dict:
    """The reference's clip under `policy` ('frames' rendered lazily)."""
    with precision.tf32(policy == "tf32"):
        solved = ref.solve(frames, params, cfg_dict, policy)
    solved["frames"] = ref.render_blocks(frames, solved, cfg_dict, frames.device)
    return solved


def readings(cand: Dict, frames: torch.Tensor, params, cfg_dict: Dict) -> Dict[str, float]:
    ref_out = reference_outputs(frames, params, cfg_dict, "f32")
    with precision.tf32(False):
        return judge.stabilizer_readings(cand, ref_out)


def run(run: harness.Run) -> harness.Outcome:
    import vstab_torch
    from vstab_torch.pipeline import clip_flow, path_to_flow, render_bucket, smooth_paths
    from vstab_torch.render.render import render_stabilized

    dev, spec, mix = run.device, run.cell.spec, run.cell.traffic
    cfg_dict = run.cell.config["program"]
    cfg = common.program_config(run.cell.config)
    params = common.params(run)
    common.build(dev)
    pool = harness.generator(mix["generator"]).generate(mix, run.seed, dev)["clips"]
    t, h, w, _ = pool[0].shape
    vstab_torch.stabilize(pool[0], params, cfg, device=dev)  # warm-up: the cell's one shape
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
        out, diags = vstab_torch.stabilize(pool[i % len(pool)], params, cfg, device=dev)
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
            st["flow"] = clip_flow(params, st["frames"], cfg)

        def smooth(st):
            st["path"], _ = smooth_paths(st["flow"], cfg, (h, w))
            st["bucket"] = render_bucket(st["path"], cfg, (h, w))[1]

        def render(st):
            st["out"] = render_stabilized(st["frames"], path_to_flow(st["path"], cfg, (h, w)),
                                          cfg.render, max_disp=st["bucket"])

        stages = {"flow": flow, "smooth": smooth, "render": render}
        with torch.inference_mode():
            for k in range(spec["trace_clips"]):
                common.timed_stages(dev, stages, spans, {"frames": pool[k % len(pool)]})

        def traced():
            for k in range(spec["trace_clips"]):
                vstab_torch.stabilize(pool[k % len(pool)], params, cfg, device=dev)

        trace = {
            "spans": spans,
            "profile": common.profiled(traced) if dev.type == "cuda" else None,
            "window": {"seconds": window_s, "flops": n * flops.clip_flops(t, h, w, cfg_dict["flow"]),
                       "peak_flops": PEAK_FLOPS[cfg_dict["flow"]["compute_dtype"]]},
        }
        run.say(f"power limit: {harness.power_limit()}")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    judged = []
    for idx, out, diags in sample.items:
        judged.append(readings(program_outputs(out, diags), pool[idx], params, cfg_dict))
        run.say(f"readings of clip {idx}: {judged[-1]}")
    checks = judge.run_checks(judged, spec["limits"])
    return harness.Outcome(e2e=e2e, attempted=n, failed=0, checks=checks,
                           memory_peak_bytes=int(peak), trace=trace)
