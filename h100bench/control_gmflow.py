"""`control.py` for the cells of entry `stabilize_gmflow`: the readings that
their limits are set from, on the card, at the cell's own size, in one
process:

    python3 h100bench/control_gmflow.py --workload stab_720p_gmflow --seeds 1 2 ... --control-seeds 1 2

- program: `vstab_torch.stabilize` with GMFlow on the clips that a run of
  that seed judges first, against the float32 reference (the lower
  readings);
- control:fp8: the reference put in the program's place with the operands
  of every layer stated in bfloat16 rounded to float8 e4m3 (the precision
  below the configuration's), against the float32 reference;
- control:match_bf16: the float32 reference with both matchings' logits
  rounded to bfloat16, against the float32 reference: whether a limit sees
  the matching kept in a lower precision than stated.

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


def _rec(seed, who, readings, t0):
    return {"seed": seed, "who": who, **readings, "s": round(time.perf_counter() - t0, 3)}


def stabilizer(run, seeds, control_seeds):
    """Yields the readings, seed by seed."""
    import torch

    import vstab_torch
    from h100bench import harness, judge
    from h100bench.drivers import common
    from h100bench.drivers import stabilize_gmflow as drv
    from h100bench.reference import precision

    cell, dev = run.cell, run.device
    cfg_dict, mix = cell.config["program"], cell.traffic
    cfg = common.program_config(cell.config)
    p = drv.params(run)
    common.build(dev)
    for seed in seeds:
        t0 = time.perf_counter()
        pool = harness.generator(mix["generator"]).generate(mix, seed, dev)["clips"]
        for i in range(cell.spec["check_clips"]):
            frames = torch.as_tensor(pool[i]).to(dev)
            with precision.tf32(False):
                ref32 = drv.reference_outputs(frames, p, cfg_dict, "f32")
            out, diags = vstab_torch.stabilize(frames, p, cfg, device=dev)
            with precision.tf32(False):
                r = judge.stabilizer_readings(drv.program_outputs(out, diags), ref32)
            r["bucket"] = ref32["bucket"]
            yield _rec(seed, f"program:{i}", r, t0)
            del out, diags
            if seed in control_seeds:
                for who, policy, match_bf16 in (("fp8", "fp8", False), ("match_bf16", "f32", True)):
                    ctl = drv.reference_outputs(frames, p, cfg_dict, policy, match_bf16)
                    ref32["frames"] = drv.ref.render_blocks(frames, ref32, cfg_dict, frames.device)
                    ctl = {k: ctl[k] for k in ("profiles", "disp", "frames")}
                    with precision.tf32(False):
                        r = judge.stabilizer_readings(ctl, ref32)
                    yield _rec(seed, f"control:{who}:{i}", r, t0)
        del pool


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100bench/control_gmflow.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness

    if not torch.cuda.is_available():
        print("h100bench/control_gmflow.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.find(args.workload)
    if cell.spec["entry"] != "stabilize_gmflow":
        print(f"h100bench/control_gmflow.py: {args.workload} is not a stabilize_gmflow cell", file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, seed=0, seconds=0.0, trace=False,
                      device=torch.device("cuda", 0), t_start=time.perf_counter())
    print(json.dumps({"card": harness.power_limit(), "torch": torch.__version__}), flush=True)
    for rec in stabilizer(run, args.seeds, set(args.control_seeds)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
