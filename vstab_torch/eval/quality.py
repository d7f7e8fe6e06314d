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

The trainer is held to `tests/torch_train_reference.json` (written by
`tests/torch_train_reference.py`) and the draws in the npz beside it:
`replay` takes the reference's steps from the same start on batches rebuilt
from the reference's own draws, and each step's loss, grad_norm and
epe_finest must lie within the reference's per-step tolerance (how far a
twin of the reference, started from parameters perturbed by 1e-6, parted
from it); `held_out_epe` scores parameters on the reference's held-out
pairs by the EPE formula of `eval_epe`.

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
TRAIN_METRICS = ("loss", "grad_norm", "epe_finest")


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


# ---------------------------------------------------------------------------
# The trainer against the JAX package's
# ---------------------------------------------------------------------------


def load_train_reference(path: str) -> dict:
    """The training reference: the JSON at `path` (the repository's
    `tests/torch_train_reference.json`), its draws from the npz beside it
    under "arrays"."""
    ref = load_reference(path)
    with np.load(os.path.splitext(path)[0] + ".npz") as z:
        ref["arrays"] = {k: z[k] for k in z.files}
    return ref


def reference_draws(ref: dict, prefix: str, device) -> Dict[str, torch.Tensor]:
    """Every step's (or held-out batch's) draws of `prefix` ("replay",
    "warm_start", "held/<set>"), stacked over the steps, on `device`: one
    upload for the run, not one a step."""
    n = len(prefix) + 1
    return {name[n:]: torch.from_numpy(v).to(device) for name, v in ref["arrays"].items()
            if name.startswith(prefix + "/")}


def draws_at(stacked: Dict[str, torch.Tensor], k: int) -> dict:
    """Step k of `reference_draws` in the form `_batch_from_draws` takes."""
    d = {name: v[k] for name, v in stacked.items()}
    occ = [{"tex": d["occ_tex"][j].long(), **{f: d[f"occ_{f}"][j] for f in ("cy", "cx", "ry", "rx", "move", "on")}}
           for j in range(d["occ_tex"].shape[0] if "occ_tex" in d else 0)]
    return {"idx": d["idx"].long(), "blur": d["blur"].long(), "angle": d["angle"], "scale": d["scale"],
            "txy": d["txy"], "coarse": d["coarse"], "occluders": occ, "gain": d["gain"], "offset": d["offset"]}


def reference_pool(ref: dict, name: str, n: int, seed: int, kinds) -> np.ndarray:
    """The port's `make_scene_pool(n, h, w, seed, kinds)`, checked against the
    sum and values the reference kept of its pool `name`."""
    from vstab_torch.flow.train import make_scene_pool

    pool = make_scene_pool(n, *ref["settings"]["hw"], seed=seed, kinds=tuple(kinds))
    digest = ref["pools"][name]
    check_clips([pool], [digest["sum"]], [digest["sample"]], f"scene pool {name}")
    return pool


def replay(ref: dict, params, run: str = "replay", steps: Optional[int] = None, device=None):
    """The first `steps` (all) steps of the reference's `run` ("replay" or
    "warm_start") from `params` (its start) through the port's trainer: the
    pool checked against the reference's, `_trainable`, `make_optimizer` with
    the run's cosine schedule, `make_train_step`, and each step's batch from
    `_batch_from_draws` on the reference's draws of that step. f32, TF32 off.
    Returns ({metric: [per step]}, end state dict); the metrics are read
    back once, at the end."""
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow import train as T
    from vstab_torch.pipeline import resolve_device

    dev = resolve_device(device)
    pin_full_f32()
    r = ref["settings"]["recipes"][run]
    steps = r["steps"] if steps is None else steps
    scenes = torch.from_numpy(reference_pool(ref, run, r["n_scenes"], r["pool_seed"], r["kinds"])).to(dev)
    net = T._trainable(params, FlowConfig(compute_dtype="float32"), dev)
    opt = T.make_optimizer(net.parameters(), r["lr"])
    step = T.make_train_step(net, opt, "supervised", T.cosine_schedule(opt, r["steps"], alpha=r["alpha"]))
    draws = reference_draws(ref, run, dev)
    out = []
    for k in range(steps):
        batch = T._batch_from_draws(scenes, draws_at(draws, k), ref["settings"]["max_disp"], blur=True)
        ms = step(batch)
        out.append(torch.stack([ms[m] for m in TRAIN_METRICS]))
    hist = torch.stack(out).cpu().double().numpy()
    return {m: hist[:, i].tolist() for i, m in enumerate(TRAIN_METRICS)}, T._state(net)


def held_out_epe(ref: dict, params, sets=None, device=None) -> Dict[str, dict]:
    """Mean EPE of `params` on the reference's held-out pairs of each set (all
    by default): batches from `_batch_from_draws(..., blur=False)` on the
    reference's draws, flow by `estimate_flow`, and `eval_epe`'s formula (per
    batch the mean of sqrt(|flow - gt|^2 + 1e-12), then the mean over the
    batches)."""
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow.pwcnet import estimate_flow
    from vstab_torch.flow.train import _batch_from_draws
    from vstab_torch.pipeline import resolve_device

    dev = resolve_device(device)
    pin_full_f32()
    held = ref["settings"]["held_out"]
    cfg = FlowConfig(compute_dtype="float32")
    p = {k: v.to(dev, torch.float32) for k, v in params.items()}
    out = {}
    for name in held["sets"] if sets is None else sets:
        kinds, _ = held["sets"][name]
        scenes = torch.from_numpy(reference_pool(ref, f"held/{name}", 8, held["seed"], kinds)).to(dev)
        draws = reference_draws(ref, f"held/{name}", dev)
        per = []
        for i in range(draws["idx"].shape[0]):
            b = _batch_from_draws(scenes, draws_at(draws, i), ref["settings"]["max_disp"], blur=False)
            fl = estimate_flow(p, b["im1"], b["im2"], cfg)
            per.append(torch.mean(torch.sqrt(torch.sum((fl - b["flow"]) ** 2, -1) + 1e-12)))
        per = torch.stack(per).cpu().double().numpy()
        out[name] = {"mean_px": float(per.mean()), "per_batch_px": per.tolist()}
    return out


def hold_steps(ref: dict, got: Dict[str, list]) -> Dict[str, dict]:
    """Each metric of the port's replay against the reference's over the
    steps `got` holds: |port - reference| within the reference's tolerance
    at every step. A row a metric: the steps held, the steps missed, the
    largest |diff| / tolerance and its step."""
    rows = {}
    for m in TRAIN_METRICS:
        n = len(got[m])
        diff = np.abs(np.asarray(got[m]) - np.asarray(ref["replay"][m][:n]))
        ratio = diff / np.asarray(ref["tolerance"][m][:n])
        worst = int(np.argmax(ratio))
        rows[m] = {"steps": n, "missed": [int(k) for k in np.nonzero(ratio > 1.0)[0]],
                   "worst_step": worst, "worst_ratio": float(ratio[worst]), "worst_diff": float(diff[worst]),
                   "ok": bool(np.all(ratio <= 1.0))}
    return rows


def hold_epes(ref: dict, got: Dict[str, dict], want: Dict[str, dict]) -> Dict[str, dict]:
    """The port's mean EPE of each set in `got` against the reference's
    reading `want` (an entry of `held_out`), within the reference's end-EPE
    tolerance of that set."""
    rows = {}
    for name, g in got.items():
        tol = ref["epe_tolerance"][name]
        diff = g["mean_px"] - want[name]["mean_px"]
        rows[name] = {"reference_px": want[name]["mean_px"], "port_px": g["mean_px"], "diff": diff,
                      "tolerance": tol, "ok": bool(abs(diff) <= tol)}
    return rows


__all__ = [
    "analytic_flow",
    "check_clips",
    "clip_scores",
    "config",
    "draws_at",
    "eval_clips",
    "gate_clip",
    "gate_readings",
    "gate_value",
    "hd720_clips",
    "held_out_epe",
    "hold_epes",
    "hold_gates",
    "hold_means",
    "hold_steps",
    "load_reference",
    "load_train_reference",
    "mean_scores",
    "noisy",
    "reference_draws",
    "reference_pool",
    "replay",
    "tolerance",
]
