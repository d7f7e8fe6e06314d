"""`control.py` for the cells of entry `train_raft`: the readings that their
limits are set from, on the card, at the cell's own size, in one process:

    python3 h100bench/control_raft_train.py --workload train_raft_chairs --seeds 1 2 ... --control-seeds 1 2 3 \
        [--faults half_batch pyramid_without_gradient]

- program: the first `check_steps` steps of the program's RAFT trainer on
  the seed's scenes and batches, against the float32 reference's (the lower
  readings);
- control:tf32: the reference put in the program's place with every
  convolution's operands rounded to TF32 and TF32 on for the card's float32
  matmuls (the precision below the configuration's float32), against the
  float32 reference (the upper readings);
- repeat: the program run again on the same seed, judged against its first
  run: how far two sound runs part (cuDNN's default algorithms are not
  deterministic);
- fault:<name>: the program with one of `FAULTS` planted underneath (with
  `--faults`), against the float32 reference (upper readings at the cell's
  own size).

Prints one JSON line a reading: {"seed", "who", readings..., "s"}.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _pyramid_without_gradient(fn):
    """The correlation pyramid cut from autograd: no gradient reaches fnet."""
    def wrapped(f1, f2, levels):
        return [t.detach() for t in fn(f1, f2, levels)]
    return wrapped


def _eleven_iterations(fn):
    """The last of the 12 iterations left out of the loss."""
    def wrapped(preds, gt, *a, **k):
        return fn(preds[:-1], gt, *a, **k)
    return wrapped


def _half_batch(fn):
    """The loss's mean taken over half of the batch."""
    def wrapped(preds, gt, *a, **k):
        n = gt.shape[0] // 2
        return fn([p[:n] for p in preds], gt[:n], *a, **k)
    return wrapped


def _frozen_statistics(fn):
    """cnet's batch norm in eval mode: running statistics normalise and stay."""
    def wrapped(p, name, x, kind, strides=(1, 2, 2), train=False):
        return fn(p, name, x, kind, strides, False)
    return wrapped


def _unchanged_step(fn):
    """A step that leaves the state unchanged (the norm is still reported)."""
    def step(self):
        import torch

        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        self.grad_norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
    return step


# Faults of the trained path: the attribute replaced, and its replacement made from the original.
FAULTS = {
    "pyramid_without_gradient": ("vstab_torch.flow.raft.corr_pyramid", _pyramid_without_gradient),
    "eleven_iterations": ("vstab_torch.flow.train.sequence_loss", _eleven_iterations),
    "half_batch": ("vstab_torch.flow.train.sequence_loss", _half_batch),
    "frozen_statistics": ("vstab_torch.flow.raft.encode", _frozen_statistics),
    "state_unchanged": ("vstab_torch.flow.train.ClippedAdamW.step", _unchanged_step),
}


@contextlib.contextmanager
def planted(fault: str):
    """The program with `FAULTS[fault]` in place while the block runs."""
    target, make = FAULTS[fault]
    mod_name, attr = target.rsplit(".", 1)
    try:
        owner = importlib.import_module(mod_name)
    except ModuleNotFoundError:  # a method: module.Class.method
        mod_name, cls = mod_name.rsplit(".", 1)
        owner = getattr(importlib.import_module(mod_name), cls)
    real = getattr(owner, attr)
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


def _rec(seed, who, readings, t0):
    return {"seed": seed, "who": who, **readings, "s": round(time.perf_counter() - t0, 3)}


def trainer(run, seeds, control_seeds, params=None, faults=()):
    """Yields the readings, seed by seed."""
    import torch

    from h100bench import harness
    from h100bench.drivers import common
    from h100bench.drivers import train_raft as drv
    from h100bench.drivers.stabilize_raft import params as raft_params
    from h100bench.reference import precision
    from h100bench.reference import raft_train as ref

    cell, dev = run.cell, run.device
    cfg_dict, recipe, mix = cell.config["program"], cell.config["recipe"], cell.traffic
    cfg = common.program_config(cell.config)
    params0 = raft_params(run) if params is None else params
    common.build(dev)
    steps = cell.spec["check_steps"]

    def program(scenes, bseed):
        gen = torch.Generator(device=dev).manual_seed(bseed)
        net, opt, step = drv.build_step(params0, cfg, recipe, dev)
        out = drv.first_steps(step, net, opt, gen, scenes, recipe, steps)
        del net, opt, step
        return out

    for seed in seeds:
        t0 = time.perf_counter()
        traffic = harness.generator(mix["generator"]).generate(mix, seed, dev)
        scenes, bseed = traffic["scenes"], traffic["batch_seed"]
        first, again = program(scenes, bseed), program(scenes, bseed)
        yield _rec(seed, "repeat", drv.trainer_readings(again, first, params0), t0)
        del again
        with precision.tf32(False):
            ref32 = ref.run(params0, scenes, bseed, cfg_dict["flow"], recipe, steps)
            yield _rec(seed, "program", drv.trainer_readings(first, ref32, params0), t0)
        for fault in faults:
            with planted(fault):
                broken = program(scenes, bseed)
            with precision.tf32(False):
                yield _rec(seed, f"fault:{fault}", drv.trainer_readings(broken, ref32, params0), t0)
            del broken
        if seed in control_seeds:
            with precision.tf32(True):
                ctl = ref.run(params0, scenes, bseed, cfg_dict["flow"], recipe, steps, "tf32")
            with precision.tf32(False):
                yield _rec(seed, "control:tf32", drv.trainer_readings(ctl, ref32, params0), t0)
            del ctl
        del first, ref32, scenes
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100bench/control_raft_train.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness

    if not torch.cuda.is_available():
        print("h100bench/control_raft_train.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.find(args.workload)
    if cell.spec["entry"] != "train_raft":
        print(f"h100bench/control_raft_train.py: {args.workload} is not a train_raft cell",
              file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, seed=0, seconds=0.0, trace=False,
                      device=torch.device("cuda", 0), t_start=time.perf_counter())
    print(json.dumps({"card": harness.power_limit(), "torch": torch.__version__}), flush=True)
    for rec in trainer(run, args.seeds, set(args.control_seeds), faults=args.faults):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
