"""Runs one cell of BENCHMARK.json once on this machine's cards.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, with --trace 1 the breakdown, and last the numbers compared
with their limits, which also end standard error. Exits 2 without a result
when there is no CUDA card or fewer than the cell asks for, and 3 when JAX
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT  # run as a script: import h100bench from the checkout, not beside it
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Build and kernel caches at fixed paths inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".h100bench_cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".h100bench_cache", "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100bench import harness

    cell = harness.Cell.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: the cell needs {cell.chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    out = harness.driver(cell.spec["entry"]).run(run)
    found = harness.forbidden_loaded()
    if found:
        print(f"h100bench: this process holds {', '.join(found)} after the window", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if run.trace:
        prof = out.trace.get("profile") if out.trace else None
        if not prof:
            print("h100bench: the profiler recorded no device time", file=sys.stderr)
            return 4
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        print(f"profiled section: {prof['kernel_launches']} launches of the program's kernels "
              f"recorded, {prof['kernel_events']} of their device events in the trace", file=sys.stderr)
    line = harness.result_line(run, out, device)
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
