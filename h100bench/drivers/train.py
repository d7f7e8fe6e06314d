"""The flow trainer: `make_train_step` on `_sample_batch`, as `train_fast`
runs them, in a closed loop; the metrics are summed on the device and read
back once every `scan_len` steps.

Set-up builds one training step (network from the checkpoint, ClippedAdamW,
the cosine schedule at step 0) and drives it through its first `check_steps`
steps on batches from the seed, which are also the warm-up; the same step
then runs the window. End to end: train_steps_per_s (all optimizer steps of
the window over the whole window, the last read-back included). Judged: the
first steps' batches, losses, first clipped gradient and parameter change
against the reference's from the same checkpoint, scenes and seed
(`judge.trainer_readings`). Traced: `trace_steps` steps with the batch maker
timed by CUDA events, and `trace_steps` steps under the profiler.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from h100bench import harness, judge
from h100bench.counts import PEAK_FLOPS
from h100bench.counts import pwcnet as flops
from h100bench.drivers import common
from h100bench.reference import precision
from h100bench.reference import train as ref_train


def build_step(params0: Dict[str, torch.Tensor], cfg, recipe: Dict, dev):
    """(network, optimizer, step) as the trainer builds them."""
    from vstab_torch.flow.pwcnet import build_net
    from vstab_torch.flow.train import cosine_schedule, make_optimizer, make_train_step

    net = build_net({k: v.detach().to(dev, torch.float32, copy=True) for k, v in params0.items()},
                    cfg.flow).train()
    opt = make_optimizer(net.parameters(), recipe["lr"], recipe["weight_decay"], recipe["clip"])
    sched = cosine_schedule(opt, recipe["schedule_steps"], recipe["schedule_alpha"])
    return net, opt, make_train_step(net, opt, recipe["mode"], sched)


def first_steps(step, net, opt, gen, scenes, recipe: Dict, steps: int) -> Dict:
    """The step driven through its first `steps` steps: what the judge reads
    of them (batches, losses, the first clipped gradient, the parameters)."""
    from vstab_torch.flow.train import _sample_batch

    beta1 = opt.defaults["betas"][0]
    names = [k for k, _ in net.named_parameters()]
    out: Dict = {"batches": [], "losses": []}
    for i in range(steps):
        b = _sample_batch(gen, scenes, recipe["batch"], recipe["max_disp"])
        m = step(b)
        out["batches"].append({k: v.detach().clone() for k, v in b.items()})
        out["losses"].append(float(m["loss"]))
        if i == 0:  # AdamW's first moment after one step is (1 - beta1) g
            out["grad1"] = {k: opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                            for k, p in zip(names, net.parameters())}
    out["params"] = {k: p.detach().clone() for k, p in zip(names, net.parameters())}
    return out


def readings(cand: Dict, params0, scenes, batch_seed: int, cfg_dict: Dict, recipe: Dict,
             steps: int, policy: str = "f32") -> Dict[str, float]:
    with precision.tf32(policy == "tf32"):
        ref = ref_train.run(params0, scenes, batch_seed, cfg_dict["flow"], recipe, steps, policy)
    with precision.tf32(False):
        return judge.trainer_readings(cand, ref, params0)


def run(run: harness.Run) -> harness.Outcome:
    from vstab_torch.flow.train import _sample_batch

    dev, spec, mix = run.device, run.cell.spec, run.cell.traffic
    cfg_dict, recipe = run.cell.config["program"], run.cell.config["recipe"]
    cfg = common.program_config(run.cell.config)
    params0 = common.params(run)
    common.build(dev)
    traffic = harness.generator(mix["generator"]).generate(mix, run.seed, dev)
    scenes = traffic["scenes"]
    gen = torch.Generator(device=dev).manual_seed(traffic["batch_seed"])
    net, opt, step = build_step(params0, cfg, recipe, dev)
    first = first_steps(step, net, opt, gen, scenes, recipe, spec["check_steps"])
    common.sync(dev)
    setup_s = harness.elapsed(run.t_start)
    run.say(f"set-up {setup_s:.3f} s: {spec['check_steps']} steps, losses {first['losses']}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    scan, n = recipe["scan_len"], 0
    t0 = time.perf_counter()
    while True:
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(scan):
            ms = step(_sample_batch(gen, scenes, recipe["batch"], recipe["max_disp"]))
            for k, v in ms.items():
                sums[k] = v if k not in sums else sums[k] + v
        last = {k: float(v) / scan for k, v in sums.items()}  # the chunk's one read-back
        n += scan
        c1 = time.perf_counter()
        if c1 - t0 >= run.seconds:
            break
    window_s = c1 - t0
    e2e = {"train_steps_per_s": n / window_s, "setup_s": setup_s}
    run.say(f"window {window_s:.3f} s: {n} steps, {e2e['train_steps_per_s']:.3f} steps/s, "
            f"last chunk {last}")

    trace = None
    if run.trace:
        batch_s: List[float] = []
        for _ in range(spec["trace_steps"]):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            b = _sample_batch(gen, scenes, recipe["batch"], recipe["max_disp"])
            ev1.record()
            step(b)
            ev1.synchronize()
            batch_s.append(ev0.elapsed_time(ev1) / 1e3)  # the batch maker's device time

        def traced():
            for _ in range(spec["trace_steps"]):
                step(_sample_batch(gen, scenes, recipe["batch"], recipe["max_disp"]))

        h, w = recipe["hw"]
        trace = {
            "spans": {"batch": batch_s},
            "profile": common.profiled(traced),
            "window": {"seconds": window_s,
                       "flops": n * flops.train_step_flops(recipe["batch"], h, w, cfg_dict["flow"]),
                       "peak_flops": PEAK_FLOPS[cfg_dict["flow"]["compute_dtype"]]},
        }
        run.say(f"power limit: {harness.power_limit()}")

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del net, opt, step
    r = readings(first, params0, scenes, traffic["batch_seed"], cfg_dict, recipe,
                 spec["check_steps"])
    checks = {name: harness.check(r[name], limit) for name, limit in spec["limits"].items()}
    return harness.Outcome(e2e=e2e, attempted=n, failed=0, checks=checks,
                           memory_peak_bytes=int(peak), trace=trace)
