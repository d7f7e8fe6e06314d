"""PWC-Net's dense stack in the published layout (the parent commit) and in
the aligned one (`vstab_torch.flow.pwcnet.prepare`), on one card.

    python perf_records/dense_align.py --parent DIR [--pairs 2] [--seconds 51] [--seed0 N]
        [--cells stab_720p_whole stab_4k_whole] [--out dense_align.txt]

DIR is a checkout of the parent commit (`git archive <commit>` unpacked into
a git-ignored directory). For each cell, pair k runs parent then change
(k even) or change then parent (k odd), both with seed N + k (N 4000000007
unless given):

- `h100bench/run.py --trace 0` in each checkout (`--trace 1` for the first
  pair): frames/s, p90, set-up, correct, and the traced run's per-layer
  metrics and breakdown;
- this script's `--profile` mode in each checkout, with that checkout's
  package first on `sys.path`: the cell's `trace_clips` clips of its
  traffic under torch.profiler, as the harness's traced run takes them,
  and the device seconds of cuDNN's channel padding (`nhwcAddPaddingKernel`),
  of `torch.cat` (`CatArrayBatchedCopy`) and of every convolution kernel by
  name (`xmma`, `implicit_gemm`, `fprop`, `dgrad`) in the second of two
  traced sections, the busy and window seconds and longest idle gaps of
  both, the host ms of `clip_flow`'s `prepare` (0 where it has none) and
  the ms a clip of as many clips again without the profiler, each between
  two synchronisations. Only for cells whose entry is `stabilize`, and for
  the first two pairs.

Prints the card's name and power limit first and `summary`'s lines last;
every line also goes to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED0 = 4000000007
PAD, CAT = "nhwcAddPaddingKernel", "CatArrayBatchedCopy"
CONV = ("xmma", "implicit_gemm", "fprop", "dgrad")


def _profile(cell_name: str, seed: int) -> dict:
    """The cell's traced section in the checkout at the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    from h100bench import harness, trace_read, weights
    from h100bench.drivers import common
    import vstab_torch
    from vstab_torch.flow import pwcnet

    dev = torch.device("cuda", 0)
    cell = harness.Cell.find(cell_name)
    cfg = common.program_config(cell.config)
    params = weights.load(os.path.join(os.getcwd(), cell.config["checkpoint"]), dev)
    common.build(dev)
    pool = harness.generator(cell.traffic["generator"]).generate(cell.traffic, seed, dev)["clips"]
    vstab_torch.stabilize(pool[0], params, cfg, device=dev)
    torch.cuda.synchronize()
    prep_ms = 0.0
    if hasattr(pwcnet, "prepare"):  # host ms of the layout, once per clip_flow call
        with torch.inference_mode():
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                pwcnet.prepare(params, cfg.flow)
                times.append(1e3 * (time.perf_counter() - t0))
                torch.cuda.synchronize()
        prep_ms = statistics.median(times)
    n = cell.spec["trace_clips"]
    windows = []
    for _ in range(2):  # the second traced section tells a first-profile effect apart
        fd, path = tempfile.mkstemp(suffix=".json", prefix="dense_align_")
        os.close(fd)
        try:
            trace_read.record(lambda: [vstab_torch.stabilize(pool[k % len(pool)], params, cfg, device=dev)
                                       for k in range(n)], path)
            s = trace_read.summarize(path)
        finally:
            os.remove(path)
        windows.append({"busy_s": s["busy_s"], "window_s": s["window_s"], "gaps": s["idle_gaps"][:4]})
    t0 = time.perf_counter()
    for k in range(2 * n):
        vstab_torch.stabilize(pool[k % len(pool)], params, cfg, device=dev)
        torch.cuda.synchronize()
    untraced_ms = 1e3 * (time.perf_counter() - t0) / (2 * n)
    by = s["by_name"]

    def total(*keys):
        return sum(v[0] for k, v in by.items() if any(x in k for x in keys))

    convs = {k[:120]: [round(v[0], 6), v[1]] for k, v in by.items() if any(x in k for x in CONV)}
    return {"cell": cell_name, "clips": n, "windows": windows, "untraced_ms_a_clip": untraced_ms,
            "pad_s": total(PAD), "pad_launches": sum(v[1] for k, v in by.items() if PAD in k),
            "cat_s": total(CAT), "conv_s": total(*CONV), "prepare_host_ms": prep_ms,
            "convs": dict(sorted(convs.items(), key=lambda kv: -kv[1][0])),
            "top": s["device_ops"]}


def summary(records) -> list:
    """Lines that sum up `records`, the JSON objects a run wrote: per cell
    and side the end-to-end metrics of the untraced harness runs, the
    medians of the profiled seconds, and whether both sides ran the same
    convolution kernels, with the launch counts where they differ."""
    out = []
    for cell in dict.fromkeys(r["cell"] for r in records):
        mine = [r for r in records if r["cell"] == cell]
        profs = {side: [r["profile"] for r in mine if r["side"] == side and r.get("profile")]
                 for side in ("parent", "change")}
        for side in ("parent", "change"):
            runs = {}
            for r in mine:
                if r["side"] == side and r.get("result") and r.get("trace") == 0:
                    for k, v in r["result"]["metrics"].items():
                        runs.setdefault(k, []).append(v["value"])
            line = {"cell": cell, "side": side, "untraced_runs": runs}
            if profs[side]:
                line.update({k: statistics.median(p[k] for p in profs[side])
                             for k in ("pad_s", "pad_launches", "cat_s", "conv_s")})
                line["busy_s"] = statistics.median(p["windows"][-1]["busy_s"] for p in profs[side])
            out.append(json.dumps(line))
        if profs["parent"] and profs["change"]:
            a, b = profs["parent"][0]["convs"], profs["change"][0]["convs"]
            moved = {k: [a.get(k, [0, 0])[1], b.get(k, [0, 0])[1]] for k in sorted(set(a) | set(b))
                     if a.get(k, [0, 0])[1] != b.get(k, [0, 0])[1]}
            out.append(f"{cell}: convolution kernel names {'the same' if set(a) == set(b) else 'differ'}"
                       f" on both sides; launches parent -> change where they differ: {json.dumps(moved)}")
    return out


def _last_json(text: str):
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--cells", nargs="+", default=["stab_720p_whole", "stab_4k_whole"])
    ap.add_argument("--out", default="dense_align.txt")
    ap.add_argument("--profile")
    ap.add_argument("--seed", type=int, default=SEED0)
    ap.add_argument("--seed0", type=int, default=SEED0)
    args = ap.parse_args()
    if args.profile:
        print(json.dumps(_profile(args.profile, args.seed)))
        return 0

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = {"parent": os.path.abspath(args.parent), "change": here}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "a")

    records = []

    def say(obj):
        if isinstance(obj, dict):
            records.append(obj)
        line = obj if isinstance(obj, str) else json.dumps(obj)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    for cell in args.cells:
        with open(os.path.join(here, "h100bench", "workloads", cell + ".json")) as f:
            entry = json.load(f)["entry"]
        for k in range(args.pairs):
            seed = args.seed0 + k
            for side in (("parent", "change") if k % 2 == 0 else ("change", "parent")):
                trace = 1 if k == 0 else 0
                t0 = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "h100bench/run.py", "--workload", cell, "--seed", str(seed),
                     "--seconds", str(args.seconds), "--trace", str(trace)],
                    cwd=roots[side], capture_output=True, text=True)
                line = _last_json(r.stdout)
                say({"cell": cell, "side": side, "seed": seed, "trace": trace, "rc": r.returncode,
                     "wall_s": round(time.perf_counter() - t0, 1), "result": line})
                if line is None:
                    say(r.stderr[-3000:])
                if entry != "stabilize" or k > 1:
                    continue
                r = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile", cell,
                                    "--seed", str(seed)], cwd=roots[side], capture_output=True, text=True)
                prof = _last_json(r.stdout)
                say({"cell": cell, "side": side, "seed": seed, "profile": prof, "rc": r.returncode})
                if prof is None:
                    say(r.stderr[-3000:])
    for line in summary(records):
        say(line)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
