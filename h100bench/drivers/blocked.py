"""Long clips from host memory through `vstab_torch.stabilize_blocked`, back
to back in a closed loop with one caller, cycling through a pool of uint8
clips on the host; each call returns float32 frames on the host.

End to end: blocked_frames_per_s (the frames of the whole clips completed
over the whole time they took; the clip in flight when the seconds run out
finishes and counts with its time). Judged: `check_clips` clips of the
window, a uniform sample drawn from the seed: every output frame, across
the block seams, against the reference. Per layer: the program's logged stage times
of the window's clips; traced, `trace_clips` clips under the profiler.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List

import torch

from h100bench import harness, judge
from h100bench.counts import PEAK_FLOPS
from h100bench.counts import pwcnet as flops
from h100bench.drivers import common
from h100bench.drivers.stabilize import reference_outputs
from h100bench.reference import precision

_LOG = "vstab_torch.blocked"


class _Stats(logging.Handler):
    """Keeps the stats record the blocked pipeline logs at the end of a call."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.stats: List[Dict] = []

    def emit(self, record):
        if str(record.msg).startswith("blocked stabilize:"):
            args = record.args
            self.stats.append(args if isinstance(args, dict) else args[0])


def readings(out, frames, params, cfg_dict: Dict, device) -> Dict[str, float]:
    ref_out = reference_outputs(torch.as_tensor(frames).to(device), params, cfg_dict, "f32")
    with precision.tf32(False):
        return judge.stabilizer_readings({"frames": judge.blocks_of(out, 16, device)}, ref_out)


def run(run: harness.Run) -> harness.Outcome:
    import vstab_torch

    dev, spec, mix = run.device, run.cell.spec, run.cell.traffic
    cfg_dict = run.cell.config["program"]
    cfg = common.program_config(run.cell.config)
    block = spec["block_len"]
    params = common.params(run)
    common.build(dev)
    pool = harness.generator(mix["generator"]).generate(mix, run.seed, dev)["clips"]
    t, h, w, _ = pool[0].shape
    catcher = _Stats()
    log = logging.getLogger(_LOG)
    log.addHandler(catcher)
    log.setLevel(logging.INFO)
    # warm-up: one whole clip, so that every shape and every pinned host buffer
    # of a call has been met once
    vstab_torch.stabilize_blocked(pool[0], params, cfg, block_len=block, device=dev)
    setup_s = harness.elapsed(run.t_start)
    run.say(f"set-up {setup_s:.3f} s: {len(pool)} clips of {t}x{h}x{w} {pool[0].dtype}")

    catcher.stats.clear()
    sample = judge.Reservoir(spec["check_clips"], run.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n = 0
    t0 = time.perf_counter()
    while True:
        out = vstab_torch.stabilize_blocked(pool[n % len(pool)], params, cfg, block_len=block,
                                            device=dev)
        c1 = time.perf_counter()
        sample.offer((n % len(pool), out))
        del out
        n += 1
        if c1 - t0 >= run.seconds:
            break
    window_s = c1 - t0
    stats = list(catcher.stats)
    e2e = {"blocked_frames_per_s": n * t / window_s, "setup_s": setup_s}
    run.say(f"window {window_s:.3f} s: {n} clips, {e2e['blocked_frames_per_s']:.3f} frames/s, "
            f"stage_s {[s['stage_s'] for s in stats]}")

    trace = None
    if run.trace:
        def traced():
            for k in range(spec["trace_clips"]):
                vstab_torch.stabilize_blocked(pool[k % len(pool)], params, cfg, block_len=block,
                                              device=dev)

        trace = {
            "blocked_stats": stats,
            "profile": common.profiled(traced) if dev.type == "cuda" else None,
            "window": {"seconds": window_s, "flops": n * flops.clip_flops(t, h, w, cfg_dict["flow"]),
                       "peak_flops": PEAK_FLOPS[cfg_dict["flow"]["compute_dtype"]]},
        }
        run.say(f"power limit: {harness.power_limit()}")
    log.removeHandler(catcher)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    judged = []
    for idx, out in sample.items:
        judged.append(readings(out, pool[idx], params, cfg_dict, dev))
        run.say(f"readings of clip {idx}: {judged[-1]}")
    checks = judge.run_checks(judged, spec["limits"])
    return harness.Outcome(e2e=e2e, attempted=n, failed=0, checks=checks,
                           memory_peak_bytes=int(peak), trace=trace)
