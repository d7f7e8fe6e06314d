"""Thousands of steps of the port's trainer on the card, against the network
the JAX package trained by the same recipe.

    python tests/torch_train_card.py [--seeds 0 1 2] [--steps 8000] [--out DIR]
    python tests/torch_train_card.py --default-cudnn-replays N [--out DIR]

Run from the root of the repository on a machine with a CUDA card. For each
seed S, one after another, it runs the port's entry point with the recipe
that made `ckpts/flow_082000.msgpack` from `ckpts/flow_074000.msgpack`:

    python -m vstab_torch.flow.train --resume ckpts/flow_074000.msgpack
        --steps 8000 --lr 1e-4 --n-scenes 256 --seed S --ckpt-dir <tmp>

(cosine over the steps to 2%, batch 8 at 192x256, blur and occluders on,
f32 with TF32 off), and times its steps from the lines it prints. Then it
scores each checkpoint saved there, `flow_074000` and `flow_082000` with the
port's `eval_epe` on the card: n = 64 held-out pairs, the in-family scenes,
the perlin scenes and the in-family scenes with occluders, the same pairs
for every network. It writes nothing under `ckpts/`; the checkpoints go to a
temporary directory that is removed at the end. With `--out DIR` each
seed's record and the summary are also written there as JSON.

The hold, fixed before any card number was read:

- for each of the three EPEs, the port's mean over the seeds is at most
  `flow_082000`'s + max(3 * s * sqrt(1 + 1/n), 0.05 px), s the sample
  standard deviation over the n seeds;
- the occluder EPE falls from `flow_074000`'s by at least half of what
  `flow_082000`'s fell.

It prints a table (each seed, mean, s, both checkpoints, ms a step, steps/s)
with the card's name and power limit, and exits 1 when the hold fails.

With `--default-cudnn-replays N` it runs instead the 500-step replay of
`chip_smoke.py`'s train parity phase N times under cuDNN's default f32
algorithms (which are not deterministic; the phase itself runs under the
deterministic ones): every step and end EPE against the JAX package's
tolerances, and the end EPEs' spread over the N runs. It exits 0 either way.

Known difference, not held: the reference's run computed its f32
convolutions at JAX's default precision on its TPU (bf16 passes); the port
trains in f32 with TF32 off.

A card-side helper, not collected by pytest; it imports torch and the port,
no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

START = "ckpts/flow_074000.msgpack"
REFERENCE = "ckpts/flow_082000.msgpack"
RECIPE = ["--resume", START, "--lr", "1e-4", "--n-scenes", "256"]
EVAL_N = 64
SETS = {"in_family": (("checker", "shapes"), False), "perlin": (("perlin",), False),
        "occluders": (("checker", "shapes"), True)}
EPE_FLOOR = 0.05


def run_seed(seed: int, steps: int, ckpt_dir: str) -> dict:
    """One run of the entry point; its output passes through, and each
    `step n/N` line is timed as it arrives."""
    cmd = [sys.executable, "-m", "vstab_torch.flow.train", *RECIPE, "--steps", str(steps), "--seed", str(seed),
           "--ckpt-dir", ckpt_dir]
    print("$ " + " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    stamps = []
    with subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            if line.startswith("step "):
                stamps.append((int(line.split()[1].split("/")[0]), time.perf_counter()))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"seed {seed}: the trainer exited with {proc.returncode}")
    (s0, t_first), (s1, t_last) = stamps[0], stamps[-1]
    ms = 1e3 * (t_last - t_first) / (s1 - s0)
    return {"seed": seed, "steps": steps, "wall_s": wall, "ms_per_step": ms, "steps_per_s": 1e3 / ms,
            "timed_steps": f"{s0 + 1}..{s1} (between the first and the last log line)",
            "ckpt": os.path.join(ckpt_dir, f"flow_{steps:06d}.msgpack")}


def epes(path: str) -> dict:
    import torch

    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow.train import eval_epe
    from vstab_torch.utils.checkpoint import load_params, params_from_jax

    params = {k: v.to("cuda") for k, v in params_from_jax(load_params(path)).items()}
    cfg = FlowConfig(compute_dtype="float32")
    out = {name: eval_epe(params, cfg, hw=(192, 256), n=EVAL_N, kinds=kinds, occluders=occ, device="cuda")
           for name, (kinds, occ) in SETS.items()}
    torch.cuda.empty_cache()
    return out


def default_cudnn_replays(n: int, card: str) -> dict:
    """The train parity phase's replay n times under cuDNN's default f32
    algorithms: each run against the JAX package's tolerances, and how far
    the runs' end EPEs lie from each other."""
    import numpy as np
    import torch

    from vstab_torch.eval import quality as q
    from vstab_torch.utils.checkpoint import load_params, params_from_jax

    ref = q.load_train_reference(os.path.join(REPO, "tests", "torch_train_reference.json"))
    start = params_from_jax(load_params(os.path.join(REPO, ref["settings"]["recipes"]["replay"]["start"])))
    torch.backends.cudnn.deterministic = False
    runs = []
    for i in range(n):
        hist, end = q.replay(ref, start, device="cuda")
        steps = q.hold_steps(ref, hist)
        epes = q.hold_epes(ref, q.held_out_epe(ref, end, device="cuda"), ref["held_out"]["replay_end"])
        kept = ("worst_ratio", "worst_step", "missed")
        runs.append({"steps": {m: {k: r[k] for k in kept} for m, r in steps.items()}, "end_epe": epes})
        print(f"default cuDNN replay {i}: worst |diff| / tolerance "
              + ", ".join(f"{m} {r['worst_ratio']:.3f} (step {r['worst_step']}, {len(r['missed'])} missed)"
                          for m, r in steps.items())
              + "; end EPE diff / tolerance "
              + ", ".join(f"{name} {r['diff']:+.4f} / {r['tolerance']:.4f}{'' if r['ok'] else ' MISSED'}"
                          for name, r in epes.items()) + f" ({card})", flush=True)
    spread = {name: float(np.std([r["end_epe"][name]["port_px"] for r in runs], ddof=1)) if n > 1 else float("nan")
              for name in runs[0]["end_epe"]}
    print("default cuDNN replays: end EPE standard deviation over the runs, px " + json.dumps(spread), flush=True)
    return {"card": card, "runs": runs, "end_epe_std_px": spread}


def hold(runs: list, start: dict, ref: dict) -> dict:
    n = len(runs)
    out = {"n_seeds": n, "rows": {}}
    for name in SETS:
        vals = [r["epe"][name] for r in runs]
        mean = sum(vals) / n
        s = math.sqrt(sum((v - mean) ** 2 for v in vals) / (n - 1)) if n > 1 else float("nan")
        slack = max(3.0 * s * math.sqrt(1.0 + 1.0 / n), EPE_FLOOR) if n > 1 else EPE_FLOOR
        out["rows"][name] = {"port_mean": mean, "port_s": s, "flow_082000": ref[name], "flow_074000": start[name],
                             "bound": ref[name] + slack, "ok": bool(mean <= ref[name] + slack)}
    occ = out["rows"]["occluders"]
    fall_ref = start["occluders"] - ref["occluders"]
    fall = start["occluders"] - occ["port_mean"]
    out["occluder_fall"] = {"port": fall, "flow_082000": fall_ref, "need": 0.5 * fall_ref,
                            "ok": bool(fall >= 0.5 * fall_ref)}
    out["ok"] = all(r["ok"] for r in out["rows"].values()) and out["occluder_fall"]["ok"]
    return out


def table(runs: list, start: dict, ref: dict, held: dict, card: str) -> str:
    head = f"{'':16}" + "".join(f"{n:>12}" for n in SETS) + f"{'ms/step':>10}{'steps/s':>9}"
    lines = [f"held-out EPE, px (port's eval_epe, n = {EVAL_N}, on {card})", head]
    for r in runs:
        lines.append(f"{'seed ' + str(r['seed']):16}" + "".join(f"{r['epe'][n]:12.4f}" for n in SETS)
                     + f"{r['ms_per_step']:10.2f}{r['steps_per_s']:9.2f}")
    rows = held["rows"]
    lines.append(f"{'mean':16}" + "".join(f"{rows[n]['port_mean']:12.4f}" for n in SETS))
    lines.append(f"{'s':16}" + "".join(f"{rows[n]['port_s']:12.4f}" for n in SETS))
    lines.append(f"{'flow_074000':16}" + "".join(f"{start[n]:12.4f}" for n in SETS))
    lines.append(f"{'flow_082000':16}" + "".join(f"{ref[n]:12.4f}" for n in SETS))
    lines.append(f"{'bound':16}" + "".join(f"{rows[n]['bound']:12.4f}" for n in SETS))
    lines.append(f"{'held':16}" + "".join(f"{str(rows[n]['ok']):>12}" for n in SETS))
    f = held["occluder_fall"]
    lines.append(f"occluder EPE fall from flow_074000: port {f['port']:.4f} px, flow_082000 {f['flow_082000']:.4f} "
                 f"px, needed {f['need']:.4f} px: {'held' if f['ok'] else 'MISSED'}")
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(prog="python tests/torch_train_card.py")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--out", default=None, help="directory for the JSON records")
    ap.add_argument("--default-cudnn-replays", type=int, default=0, metavar="N",
                    help="instead: the train parity replay N times under cuDNN's default algorithms")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    from vstab_torch.bench import card as card_line

    card = card_line()
    print(card, flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.default_cudnn_replays:
        out = default_cudnn_replays(args.default_cudnn_replays, card)
        if args.out:
            with open(os.path.join(args.out, "default_cudnn_replays.json"), "w") as f:
                json.dump(out, f, indent=1)
        return 0
    tmp = tempfile.mkdtemp(prefix="vstab_finetune_")
    try:
        runs = []
        for seed in args.seeds:
            rec = run_seed(seed, args.steps, os.path.join(tmp, f"seed{seed}"))
            t0 = time.perf_counter()
            rec["epe"] = epes(rec.pop("ckpt"))
            rec["eval_s"] = time.perf_counter() - t0
            rec["card"] = card
            print("run " + json.dumps(rec), flush=True)
            runs.append(rec)
            if args.out:
                with open(os.path.join(args.out, f"seed{seed}.json"), "w") as f:
                    json.dump(rec, f, indent=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    start, ref = (epes(os.path.join(REPO, p)) for p in (START, REFERENCE))
    held = hold(runs, start, ref)
    summary = {"card": card, "steps": args.steps, "recipe": RECIPE, "eval_n": EVAL_N, "runs": runs,
               "flow_074000": start, "flow_082000": ref, "hold": held}
    print(table(runs, start, ref, held, card), flush=True)
    print("summary " + json.dumps(summary), flush=True)
    if args.out:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0 if held["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
