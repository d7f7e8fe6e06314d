"""RAFT's chairs stage on the port's trainer: `make_train_step` over a RAFT
module (`vstab_torch.flow.raft.build_net`) with RAFT's sequence loss,
`ClippedAdamW` and torch's `OneCycleLR` as the recipe gives it, on `_sample_batch`'s batches of
the scene pool, in the closed loop of `drivers/train.py`: the metrics are
summed on the device and read back once every `scan_len` steps.

Set-up draws RAFT's weights from the configuration's seed, builds one
training step and drives it through its first `check_steps` steps on batches
from the seed, which are also the warm-up; the same step then runs the
window. End to end: train_steps_per_s (all optimizer steps of the window
over the whole window, the last read-back included). Judged: the first
steps' batches, losses, first clipped gradient and change of the parameters
and of `cnet`'s running statistics against `reference/raft_train.py`'s from
the same weights, scenes and seed. Traced: `trace_steps` steps with the
batch maker timed by CUDA events, and `trace_steps` steps under the profiler
with the program's spans and every kernel launch recorded: the lookup's and
its backward's launches counted by `counts/raft.py` and
`counts/raft_train.py`, the batch maker's warps by `counts/kernels.py`.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from h100bench import harness, judge, trace_read
from h100bench.counts import PEAK_FLOPS
from h100bench.counts import kernels as kernel_counts
from h100bench.counts import raft as raft_counts
from h100bench.counts import raft_train as counts
from h100bench.drivers import common
from h100bench.drivers import train as train_drv
from h100bench.drivers.stabilize_raft import params as raft_params
from h100bench.reference import precision
from h100bench.reference import raft_train as ref

LOOKUP, LOOKUP_BWD = "vstab_corr_lookup", "vstab_corr_lookup_bwd"
# the kernels' names in the profiler's trace
LOOKUP_KERNEL, LOOKUP_BWD_KERNEL = "corr_lookup_kernel", "corr_lookup_bwd_kernel"


def build_step(params0: Dict[str, torch.Tensor], cfg, recipe: Dict, dev):
    """(network, optimizer, step) as the trainer builds them for RAFT."""
    from vstab_torch.flow import raft
    from vstab_torch.flow.train import make_optimizer, make_train_step

    net = raft.build_net(params0, cfg.flow, dev)
    opt = make_optimizer(net.parameters(), recipe["lr"], recipe["weight_decay"], recipe["clip"])
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=recipe["lr"], total_steps=recipe["schedule_steps"], pct_start=recipe["pct_start"],
        anneal_strategy="linear", cycle_momentum=False, div_factor=recipe["div_factor"],
        final_div_factor=recipe["final_div_factor"])
    return net, opt, make_train_step(net, opt, recipe["mode"], sched)


def first_steps(step, net, opt, gen, scenes, recipe: Dict, steps: int) -> Dict:
    """`drivers/train.py`'s first steps, with `cnet`'s running statistics after them."""
    out = train_drv.first_steps(step, net, opt, gen, scenes, recipe, steps)
    out["stats"] = {k: b.detach().clone() for k, b in net.named_buffers() if ref.is_stat(k)}
    return out


def trainer_readings(cand: Dict, ref_out: Dict, params0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """`judge.trainer_readings` over the trained leaves, with the change of
    `cnet`'s running statistics counted beside the parameters' in
    update_median. Both hold 'stats' beside what the judge reads."""
    state0 = ref.trained_state(params0)
    leaves0 = {k: v for k, v in state0.items() if not ref.is_stat(k)}
    out = judge.trainer_readings(cand, ref_out, leaves0)
    _, update = judge.leaf_gaps(cand, ref_out, leaves0)
    stats0 = {k: v for k, v in state0.items() if ref.is_stat(k)}
    moved = [{k: s[k].float() - stats0[k] for k in stats0} for s in (cand["stats"], ref_out["stats"])]
    stats = judge._leaf_gaps(*moved)
    out["update_median"] = float(torch.tensor(list(update.values()) + list(stats.values()),
                                              dtype=torch.float64).median())
    return out


def readings(cand: Dict, params0, scenes, batch_seed: int, cfg_dict: Dict, recipe: Dict,
             steps: int) -> Dict[str, float]:
    """The program's first steps against the float32 reference's."""
    with precision.tf32(False):
        ref_out = ref.run(params0, scenes, batch_seed, cfg_dict["flow"], recipe, steps)
        return trainer_readings(cand, ref_out, params0)


def profiled(run_fn: Callable[[], None]) -> Optional[Dict]:
    """`run_fn` once under the profiler, every kernel launch recorded: the
    trace's summary plus the launches' least time, the profiler's time of
    the kernels and the launches, for the lookup's backward
    ('lookup_bwd_*') and for all the port's kernels, the lookup, its
    backward and the batch maker's warps ('kernel_*'); None without device
    events."""
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

    fwd = [a for s, a in calls if s == LOOKUP]
    bwd = [a for s, a in calls if s == LOOKUP_BWD]
    rest = [(s, a) for s, a in calls if s not in (LOOKUP, LOOKUP_BWD)]
    summary["lookup_bwd_bound_s"] = sum(counts.lookup_bwd_bound_s(a) for a in bwd)
    summary["lookup_bwd_launches"] = len(bwd)
    summary["lookup_bwd_device_s"], summary["lookup_bwd_events"] = device((LOOKUP_BWD_KERNEL,))
    summary["kernel_bound_s"] = (sum(kernel_counts.bound_s(s, a) for s, a in rest) + summary["lookup_bwd_bound_s"]
                                 + sum(raft_counts.lookup_bound_s(a) for a in fwd))
    summary["kernel_launches"] = len(calls)
    summary["kernel_device_s"], summary["kernel_events"] = device(
        common.PORT_KERNELS + (LOOKUP_KERNEL, LOOKUP_BWD_KERNEL))
    return summary


def timed_batches(step, make_batch: Callable[[], Dict], steps: int) -> List[float]:
    """`steps` steps, each batch maker's device seconds between CUDA events
    around it, as `drivers/train.py` times it."""
    out = []
    for _ in range(steps):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        b = make_batch()
        ev1.record()
        step(b)
        ev1.synchronize()
        out.append(ev0.elapsed_time(ev1) / 1e3)
    return out


def run(run: harness.Run) -> harness.Outcome:
    # a program that cannot train RAFT stops here, before any work
    from vstab_torch.flow.raft import build_net, train_forward  # noqa: F401
    from vstab_torch.flow.train import _sample_batch

    dev, spec, mix = run.device, run.cell.spec, run.cell.traffic
    cfg_dict, recipe = run.cell.config["program"], run.cell.config["recipe"]
    cfg = common.program_config(run.cell.config)
    params0 = raft_params(run)
    common.build(dev)
    traffic = harness.generator(mix["generator"]).generate(mix, run.seed, dev)
    scenes = traffic["scenes"]
    gen = torch.Generator(device=dev).manual_seed(traffic["batch_seed"])
    net, opt, step = build_step(params0, cfg, recipe, dev)
    first = first_steps(step, net, opt, gen, scenes, recipe, spec["check_steps"])
    common.sync(dev)
    setup_s = harness.elapsed(run.t_start)
    run.say(f"set-up {setup_s:.3f} s: {spec['check_steps']} steps, losses {first['losses']}")

    def one():
        return step(_sample_batch(gen, scenes, recipe["batch"], recipe["max_disp"]))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    scan, n = recipe["scan_len"], 0
    t0 = time.perf_counter()
    while True:
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(scan):
            for k, v in one().items():
                sums[k] = v if k not in sums else sums[k] + v
        last = {k: round(float(v) / scan, 4) for k, v in sums.items()}  # the chunk's one read-back
        n += scan
        c1 = time.perf_counter()
        if c1 - t0 >= run.seconds:
            break
    window_s = c1 - t0
    e2e = {"train_steps_per_s": n / window_s, "setup_s": setup_s}
    run.say(f"window {window_s:.3f} s: {n} steps, {e2e['train_steps_per_s']:.4f} steps/s, "
            f"last chunk {last}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    trace = None
    if run.trace:
        batch_s = timed_batches(step, lambda: _sample_batch(gen, scenes, recipe["batch"], recipe["max_disp"]),
                                spec["trace_steps"]) if dev.type == "cuda" else []

        def traced():
            for _ in range(spec["trace_steps"]):
                one()

        h, w = recipe["hw"]
        trace = {
            "spans": {"batch": batch_s},
            "profile": profiled(traced) if dev.type == "cuda" else None,
            "window": {"seconds": window_s,
                       "flops": n * counts.step_ops(recipe["batch"], h, w, cfg_dict["flow"]),
                       "peak_flops": PEAK_FLOPS["float32"]},
        }
        prof = trace["profile"] or {}
        run.say(f"profile: busy {prof.get('busy_s')} of {prof.get('window_s')} s; batch maker "
                f"{batch_s} s; the port's kernels {prof.get('kernel_launches')} launches "
                f"{prof.get('kernel_device_s')} s (bound {prof.get('kernel_bound_s')} s), the lookup's backward "
                f"{prof.get('lookup_bwd_launches')} launches {prof.get('lookup_bwd_device_s')} s "
                f"(bound {prof.get('lookup_bwd_bound_s')} s); top {prof.get('device_ops')}")
        run.say(f"power limit: {harness.power_limit()}")

    del net, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r = readings(first, params0, scenes, traffic["batch_seed"], cfg_dict, recipe, spec["check_steps"])
    run.say(f"readings: {r}")
    checks = {name: harness.check(r[name], limit) for name, limit in spec["limits"].items()}
    return harness.Outcome(e2e=e2e, attempted=n, failed=0, checks=checks,
                           memory_peak_bytes=int(peak), trace=trace)


__all__ = ["build_step", "first_steps", "profiled", "readings", "run", "trainer_readings"]

