"""The readings that a cell's limits are set from, on the card, at the
cell's own size, in one process:

    python3 h100bench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3

- program: the cell's entry on the clips (or first steps) that a run of that
  seed judges first, against the reference (the lower readings);
- control: the reference put in the program's place in the precision below
  the one the configuration states (fp8 for the stabilizer's bfloat16 flow
  network, TF32 for the trainer's float32), against the float32 reference;
- fault:half_batch (trainer): the reference put in the program's place with
  its loss taken over half of each batch; a step that leaves the state
  unchanged reads 1 by construction and needs no run;
- repeat (trainer): the program run again on the same seed, judged against
  its first run: how far two sound runs part (cuDNN's default algorithms
  are not deterministic).

Prints one JSON line a reading: {"seed", "who", readings..., "s"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LOWER = {"bfloat16": "fp8", "float32": "tf32"}


def _rec(seed, who, readings, t0):
    return {"seed": seed, "who": who, **readings, "s": round(time.perf_counter() - t0, 3)}


def stabilizer(run, seeds, control_seeds, blocked: bool, params=None):
    """Yields the stabilizer's readings, seed by seed."""
    import torch

    import vstab_torch
    from h100bench import harness, judge
    from h100bench.drivers import common
    from h100bench.drivers import stabilize as drv
    from h100bench.reference import precision

    cell, dev = run.cell, run.device
    cfg_dict, mix = cell.config["program"], cell.traffic
    cfg = common.program_config(cell.config)
    params = common.params(run) if params is None else params
    common.build(dev)
    low = LOWER[cfg_dict["flow"]["compute_dtype"]]
    for seed in seeds:
        t0 = time.perf_counter()
        pool = harness.generator(mix["generator"]).generate(mix, seed, dev)["clips"]
        for i in range(1 if blocked else cell.spec["check_clips"]):
            frames = torch.as_tensor(pool[i]).to(dev)
            with precision.tf32(False):
                ref32 = drv.reference_outputs(frames, params, cfg_dict, "f32")
            if blocked:
                out = vstab_torch.stabilize_blocked(pool[i], params, cfg,
                                                    block_len=cell.spec["block_len"], device=dev)
                cand = {"frames": judge.blocks_of(out, 16, dev)}
            else:
                out, diags = vstab_torch.stabilize(frames, params, cfg, device=dev)
                cand = drv.program_outputs(out, diags)
            with precision.tf32(False):
                r = judge.stabilizer_readings(cand, ref32)
            yield _rec(seed, f"program:{i}", r, t0)
            del out, cand
            if seed in control_seeds:
                ctl = drv.reference_outputs(frames, params, cfg_dict, low)
                ref32["frames"] = _render(frames, ref32, cfg_dict)
                # judged as the program is: the blocked cell by its frames alone
                keys = ("frames",) if blocked else ("profiles", "disp", "frames")
                ctl = {k: ctl[k] for k in keys}
                with precision.tf32(False):
                    r = judge.stabilizer_readings(ctl, ref32)
                yield _rec(seed, f"control:{low}:{i}", r, t0)
        del pool


def _render(frames, solved, cfg_dict):
    from h100bench.reference import stabilize as ref

    return ref.render_blocks(frames, solved, cfg_dict, frames.device)


def trainer(run, seeds, control_seeds, params=None):
    """Yields the trainer's readings, seed by seed."""
    import torch

    from h100bench import harness, judge
    from h100bench.drivers import common
    from h100bench.drivers import train as drv
    from h100bench.reference import precision
    from h100bench.reference import train as ref_train

    cell, dev = run.cell, run.device
    cfg_dict, recipe, mix = cell.config["program"], cell.config["recipe"], cell.traffic
    cfg = common.program_config(cell.config)
    params0 = common.params(run) if params is None else params
    common.build(dev)
    steps = cell.spec["check_steps"]
    low = LOWER[cfg_dict["flow"]["compute_dtype"]]
    for seed in seeds:
        t0 = time.perf_counter()
        traffic = harness.generator(mix["generator"]).generate(mix, seed, dev)
        scenes, bseed = traffic["scenes"], traffic["batch_seed"]
        gen = torch.Generator(device=dev).manual_seed(bseed)
        net, opt, step = drv.build_step(params0, cfg, recipe, dev)
        first = drv.first_steps(step, net, opt, gen, scenes, recipe, steps)
        gen = torch.Generator(device=dev).manual_seed(bseed)
        net, opt, step = drv.build_step(params0, cfg, recipe, dev)
        again = drv.first_steps(step, net, opt, gen, scenes, recipe, steps)
        del net, opt, step
        yield _rec(seed, "repeat", judge.trainer_readings(again, first, params0), t0)
        with precision.tf32(False):
            ref32 = ref_train.run(params0, scenes, bseed, cfg_dict["flow"], recipe, steps)
            r = {**judge.trainer_readings(first, ref32, params0), **_worst_leaves(first, ref32, params0)}
        yield _rec(seed, "program", r, t0)
        if seed in control_seeds:
            with precision.tf32(True):
                ctl = ref_train.run(params0, scenes, bseed, cfg_dict["flow"], recipe, steps, low)
            with precision.tf32(False):
                r = judge.trainer_readings(ctl, ref32, params0)
            yield _rec(seed, f"control:{low}", r, t0)
            with precision.tf32(False):
                half = ref_train.run(params0, scenes, bseed, cfg_dict["flow"], recipe, steps,
                                     loss_rows=recipe["batch"] // 2)
                r = judge.trainer_readings(half, ref32, params0)
            yield _rec(seed, "fault:half_batch", r, t0)


def _worst_leaves(cand, ref, params0, n=3):
    """The leaves of the largest gaps of the first gradient and of the change
    (diagnostics: the worst leaf is not compared), as [leaf, gap]."""
    from h100bench import judge

    grad, update = judge.leaf_gaps(cand, ref, params0)
    return {f"worst_{key}": [[k, gaps[k]] for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]
            for key, gaps in (("grad", grad), ("update", update))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness

    if not torch.cuda.is_available():
        print("h100bench/control.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.find(args.workload)
    run = harness.Run(cell=cell, seed=0, seconds=0.0, trace=False,
                      device=torch.device("cuda", 0), t_start=time.perf_counter())
    print(json.dumps({"card": harness.power_limit(), "torch": torch.__version__}), flush=True)
    entry = cell.spec["entry"]
    if entry == "train":
        records = trainer(run, args.seeds, set(args.control_seeds))
    else:
        records = stabilizer(run, args.seeds, set(args.control_seeds), blocked=entry == "blocked")
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
