"""The port held to the JAX package's quality readings.

`tests/torch_quality_reference.json` holds what the JAX package reads on the
CPU (it is written by `tests/torch_quality_reference.py`, the one place that
runs the JAX package): the three scores of the eval set, of three 720p
clips and of every clip and Config of its integration gates
(tests/integration/test_synthetic.py, test_trained.py, test_dynamic.py),
each gate clip noiseless and under K input-noise draws; the spread of the
scores under those draws, and the tolerances fixed from it. This module runs
the same clips through the port and holds the results to that file:

- a gate is held on the mean over the K draws: where the reference's own
  mean clears it, the port's must clear it too; where it does not, the
  port's must lie within the tolerance for n = K of the reference's mean;
- the mean of a score over n clips must lie within the tolerance for n of
  the reference's mean over the same clips.

The tests on the CPU and `chip_smoke.py` on the card call it.
"""

from __future__ import annotations

import copy
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from vstab_torch.core.config import Config
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.eval.metrics import evaluate_videos

SCORES = ("stability", "cropping", "distortion")
NOISE_AMP = 1e-4


def load_reference(path: str) -> dict:
    """The reference's readings: `tests/torch_quality_reference.json` of the
    repository."""
    with open(path) as f:
        return json.load(f)


def noisy(frames: np.ndarray, k: int) -> np.ndarray:
    """Draw k of the input noise: uniform +-1e-4 from default_rng(k), clipped
    to [0, 1] (the reference's draws, the same numpy calls)."""
    noise = np.random.default_rng(k).uniform(-NOISE_AMP, NOISE_AMP, frames.shape).astype(np.float32)
    return np.clip(frames + noise, 0.0, 1.0)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for key, val in over.items():
        out[key] = _merge(out.get(key, {}), val) if isinstance(val, dict) else val
    return out


def config(overrides: dict, dtype: Optional[str] = None) -> Config:
    """A run's Config: its overrides on the default Config, the flow's
    compute dtype set to `dtype` where given."""
    over = _merge(overrides, {"flow": {"compute_dtype": dtype}} if dtype else {})
    return Config.from_json(json.dumps(_merge(json.loads(Config().to_json()), over)))


def gate_clip(ref: dict, name: str):
    """(frames, camera path) of a gate clip. The port's generator draws with
    numpy alone, as the reference's clips were drawn."""
    from vstab_torch.eval import synthetic

    fn, kw = ref["settings"]["gate_clips"][name]
    return getattr(synthetic, fn)(**kw)


def eval_clips(ref: dict, n: Optional[int] = None):
    """The first n (all N) clips of the eval set, [(name, frames)], on the
    pool's threads (numpy lets go of the GIL)."""
    from vstab_torch.eval.deepstab import synthetic_clip

    n = ref["N"] if n is None else n
    t, h, w = ref["settings"]["eval_shape"]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(lambda i: synthetic_clip(i, t, h, w), range(n)))


def hd720_clips(ref: dict) -> List[np.ndarray]:
    """The reference's 48x720x1280 clips."""
    from vstab_torch.eval.synthetic import make_shaky_clip

    with ThreadPoolExecutor(max_workers=3) as pool:
        return list(pool.map(lambda s: make_shaky_clip(t=48, h=720, w=1280, seed=s)[0], ref["hd720"]["seeds"]))


def check_clips(frames: List[np.ndarray], sums: List[float], samples: List[List[float]], what: str) -> None:
    """Raises unless each clip is the one the reference scored: its sum to
    1e-6 a value and the 64 values it kept (places from default_rng(0)) to
    1e-5. Drawn by OpenCV instead (the JAX package's generator where it is
    installed), the frames' resampling and the occluders differ; another
    numpy moves a few values by float rounding."""
    bad = []
    for i, (f, want_sum, want) in enumerate(zip(frames, sums, samples)):
        idx = np.random.default_rng(0).integers(0, f.size, len(want))
        if (abs(float(np.asarray(f, np.float64).sum()) - want_sum) > 1e-6 * f.size
                or np.abs(np.asarray(f).reshape(-1)[idx] - np.asarray(want)).max() > 1e-5):
            bad.append(i)
    if bad or not len(frames) == len(sums) == len(samples):
        raise ValueError(f"{what}: clips {bad} (of {len(frames)}, {len(sums)} in the reference) are not the "
                         "reference's")


def analytic_flow(cams: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """The clip's pair flow from its known camera path."""
    from vstab_torch.core.types import compose_affine, invert_affine
    from vstab_torch.render.render import affine_to_flow

    c = torch.from_numpy(np.asarray(cams, np.float32)).to(device)
    return affine_to_flow(compose_affine(invert_affine(c[1:]), c[:-1]), h, w)


def _scorer() -> ThreadPoolExecutor:
    """Host threads for OpenCV's tracking, while the device goes on with the
    next clip: `pool.submit(evaluate_videos, input, output)`."""
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def _resolve(tree):
    """Futures in nested dicts and lists -> their results."""
    if isinstance(tree, dict):
        return {k: _resolve(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_resolve(v) for v in tree]
    return tree.result() if hasattr(tree, "result") else tree


def mean_scores(recs: List[dict]) -> Dict[str, float]:
    """The mean of each key of the records (the scores, or a px reading)."""
    return {k: float(np.mean([r[k] for r in recs])) for k in recs[0]}


def gate_readings(ref: dict, params, dtype: str, device, runs: Optional[List[str]] = None,
                  clips: Optional[dict] = None) -> dict:
    """The reference's gate runs (those named in `runs`, all by default), the
    inputs' scores and the path deviation where a gate of those runs reads
    them, noiseless and under each of the K draws, with `dtype` flow; shaped
    as the reference's `gates.float32`. The clips are the port's, checked
    against the reference's sums, unless `clips` gives them by name as
    (frames, camera path), drawn and checked by the caller."""
    from vstab_torch.pipeline import clip_flow, smooth_and_render, smooth_paths, stabilize_from_flow

    pin_full_f32()
    s = ref["settings"]
    runs = {n: r for n, r in s["gate_runs"].items() if runs is None or n in runs}
    needed = {m for g in ref["gates"]["list"] if g["run"] in runs or g["run"] == "path_deviation"
              and s["path_deviation_run"] in runs for m in (g["run"], g.get("minus", ""))}
    inputs = [n for n in s["input_clips"] if f"input:{n}" in needed]
    with_dev = "path_deviation" in needed
    if clips is None:
        clips = {n: gate_clip(ref, n) for n in {r["clip"] for r in runs.values()} | set(inputs)
                 | ({"dynamic_seed3", "shaky_seed3"} if with_dev else set())}
        check_clips([f for f, _ in clips.values()], [s["gate_clip_sums"][n] for n in clips],
                    [s["gate_clip_samples"][n] for n in clips], "gate clips")
    h, w = s["gate_shape"][1:]
    p = {k: v.to(device) for k, v in params.items()}
    net_cfg = config(s["gate_runs"][s["path_deviation_run"]]["config"], dtype)  # every net run's cfg.flow
    got = {"runs": {n: {"draws": []} for n in runs}, "inputs": {n: {"draws": []} for n in inputs}}
    if with_dev:
        got["path_deviation"] = {"draws": []}

    def put(rec, k, v):
        if k is None:
            rec["noiseless"] = v
        else:
            rec["draws"].append(v)

    with _scorer() as pool:
        for k in [None, *range(s["K"])]:
            frames = {n: (f if k is None else noisy(f, k)) for n, (f, _) in clips.items()}
            on_dev = {n: torch.from_numpy(f).to(device) for n, f in frames.items()}
            flows = {}

            def flow_of(clip):
                if clip not in flows:
                    flows[clip] = clip_flow(p, on_dev[clip], net_cfg)
                return flows[clip]

            for name, run in runs.items():
                cfg = config(run["config"], dtype)
                fr = on_dev[run["clip"]]
                if run["flow"] == "analytic":
                    out, _ = smooth_and_render(fr, analytic_flow(clips[run["clip"]][1], h, w, device), cfg)
                else:
                    out, _ = stabilize_from_flow(fr, flow_of(run["clip"]), cfg)
                put(got["runs"][name], k, pool.submit(evaluate_videos, frames[run["clip"]], out.cpu().numpy()))
            for name in inputs:
                put(got["inputs"][name], k, pool.submit(evaluate_videos, frames[name], frames[name]))
            if with_dev:
                pd, _ = smooth_paths(flow_of("dynamic_seed3"), net_cfg, (h, w))
                ps, _ = smooth_paths(flow_of("shaky_seed3"), net_cfg, (h, w))
                put(got["path_deviation"], k, {"px": float((pd - ps).abs().mean())})
        got = _resolve(got)
    for rec in [*got["runs"].values(), *got["inputs"].values(), *([got["path_deviation"]] if with_dev else [])]:
        rec["mean"] = mean_scores(rec["draws"])
    return got


def gate_value(gate: dict, readings: dict, which: str = "mean") -> float:
    """A gate's value from readings shaped as `gate_readings` returns them:
    `which` is "mean" (over the draws) or "noiseless"."""
    def reading(name):
        if name.startswith("input:"):
            return readings["inputs"][name[6:]][which]
        if name == "path_deviation":
            return readings["path_deviation"][which]
        return readings["runs"][name][which]

    v = reading(gate["run"])[gate["score"]]
    if "minus" in gate:
        v -= reading(gate["minus"])[gate["score"]]
    return v


def tolerance(ref: dict, dtype: str, n: int, score: str) -> float:
    """The reference's tolerance of a mean over n clips (or draws)."""
    return ref["tolerance"][dtype][str(n)][score]


def hold_gates(ref: dict, readings: dict, dtype: str) -> List[dict]:
    """One row a gate: its threshold, the reference's mean (f32) and noiseless
    reading, the port's, what the port is held to and whether it holds.
    Where the reference's mean clears the gate the port's must too; where it
    does not, the port's must lie within the tolerance for n = K (of
    `dtype`) of the reference's mean. Gates of runs that `readings` lacks
    are left out."""
    k = ref["settings"]["K"]
    have = {*readings["runs"], *(f"input:{n}" for n in readings["inputs"]), *readings.keys()}
    rows = []
    for g in ref["gates"]["list"]:
        if not {g["run"], g.get("minus", g["run"])} <= have:
            continue  # a run these readings left out
        mean, once = gate_value(g, readings), gate_value(g, readings, "noiseless")
        row = {"gate": g["name"], "op": g["op"], "threshold": g["threshold"], "reference_mean": g["reference_mean"],
               "reference_noiseless": g["reference_noiseless"], "port_mean": mean, "port_noiseless": once}
        if g["reference_clears"]:
            row["held_to"] = f"{g['op']} {g['threshold']:g}"
            ok = mean > g["threshold"] if g["op"] == ">" else mean < g["threshold"]
        else:
            if g["score"] not in SCORES:
                raise ValueError(f"gate {g['name']!r}: the reference misses it and a {g['score']} has no tolerance")
            tol = tolerance(ref, dtype, k, g["score"])
            bound = g["reference_mean"] - tol if g["op"] == ">" else g["reference_mean"] + tol
            row["held_to"] = f"{g['op']}= reference mean {'-' if g['op'] == '>' else '+'} {tol:.4f} = {bound:.4f}"
            ok = mean >= bound if g["op"] == ">" else mean <= bound
        row["ok"] = bool(ok)
        rows.append(row)
    return rows


def hold_means(ref_means: Dict[str, float], port_means: Dict[str, float], ref: dict, dtype: str,
               n: int) -> List[dict]:
    """One row a score: the reference's and the port's mean over the same n
    clips, their difference and the tolerance for n (of `dtype`)."""
    rows = []
    for s in SCORES:
        tol = tolerance(ref, dtype, n, s)
        diff = port_means[s] - ref_means[s]
        rows.append({"score": s, "reference_mean": ref_means[s], "port_mean": port_means[s], "diff": diff,
                     "tolerance": tol, "ok": bool(abs(diff) <= tol)})
    return rows


def clip_scores(named_frames, params, cfg: Config, device) -> List[dict]:
    """`stabilize` on each (name, frames) and the three scores of each."""
    from vstab_torch.pipeline import stabilize

    p = {k: v.to(device) for k, v in params.items()}
    with _scorer() as pool:
        futures = [pool.submit(evaluate_videos, frames, stabilize(frames, p, cfg, device=device)[0].cpu().numpy())
                   for _, frames in named_frames]
        return [f.result() for f in futures]


__all__ = [
    "analytic_flow",
    "check_clips",
    "clip_scores",
    "config",
    "eval_clips",
    "gate_clip",
    "gate_readings",
    "gate_value",
    "hd720_clips",
    "hold_gates",
    "hold_means",
    "load_reference",
    "mean_scores",
    "noisy",
    "tolerance",
]
