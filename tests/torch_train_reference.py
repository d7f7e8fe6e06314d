"""The JAX package's training readings, which the port's trainer is held to.

    JAX_PLATFORMS=cpu python tests/torch_train_reference.py --write

writes `tests/torch_train_reference.json` and, beside it, the draws in
`tests/torch_train_reference.npz`. Only the JAX package writes them, on the
CPU (kernel_impl="xla", f32), and they do not change unless the JAX package
does. A test helper, not collected by pytest: it imports `vstab` and nothing
of `vstab_torch`. The port (its tests on the CPU, `chip_smoke.py` on the
card) only reads the files, through `vstab_torch.eval.quality`.

What it holds, with every setting beside the numbers:

- replay: K steps of the recipe that made `flow_082000` from `flow_074000`
  (lr 1e-4, cosine over K to 2%, batch 8 at 192x256, max_disp 12, blur and
  occluders on, a 256-scene checker+shapes pool of seed 0, keys from
  PRNGKey(0) split once a step as `train_fast` splits them), each step's
  loss, grad_norm and epe_finest;
- twin: the same K steps from the start's leaves times (1 + 1e-6 u), u
  uniform in +-1 from numpy.random.default_rng(0) leaf by leaf in
  `tree_leaves` order; the per-step tolerance is max(3 * the largest
  |twin - replay| up to that step, 1e-4 * |replay|), how far two f32
  trajectories of the reference itself part;
- the draws of every step (the npz), made by the same key splits as
  `_sample_batch`, from which the port rebuilds the same batches;
- held-out pairs: n = 64 of `eval_epe`'s pairs (scenes of seed 999,
  blur off, batch i under fold_in(PRNGKey(999), i)) for the in-family and
  perlin families without and with occluders, their draws, and the mean
  EPE on them of `flow_074000`, the replay's end and the twin's end; the
  end-EPE tolerance is max(3 * |twin - replay|, 0.01 px);
- warm_start: `chip_smoke.py`'s warm start (20 steps from `flow_086000`,
  lr 2e-4 cosine over 20, a 64-scene pool of seed 1, PRNGKey(1)), its steps
  and the EPEs on the held-out pairs before and after;
- train_fast_check: `train_fast(..., steps=2, scan_len=2)`'s printed chunk
  mean against the loop's two steps (the loop stands in for `train_fast`,
  whose scan takes about a minute a step on the CPU; a jitted step takes
  about 1.4 s).

Every pool is drawn by the generator's numpy paths (OpenCV hidden, as in
`torch_quality_reference.py`); each pool's sum and 64 of its values are kept.
The JSON is rewritten as each entry finishes (`partial` is true until the
last).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if HERE not in sys.path:  # torch_quality_reference, run as a script or imported by a test
    sys.path.insert(0, HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from torch_quality_reference import clip_sample, clip_sum, numpy_drawing  # noqa: E402

JSON_PATH = os.path.join(HERE, "torch_train_reference.json")
NPZ_PATH = os.path.join(HERE, "torch_train_reference.npz")

K = 500
HW = (192, 256)
BATCH = 8
MAX_DISP = 12.0
METRICS = ("loss", "grad_norm", "epe_finest")
TWIN_AMP = 1e-6
TOL_SPREAD = 3.0
TOL_REL_FLOOR = 1e-4
EPE_TOL_FLOOR = 0.01
RECIPES = {
    # the recipe of flow_082000 (commit 4e867d3): `python -m vstab.flow.train --resume
    # ckpts/flow_074000.msgpack --steps 8000 --lr 1e-4 --n-scenes 256`, cut to K steps
    "replay": {"start": "ckpts/flow_074000.msgpack", "steps": K, "lr": 1e-4, "alpha": 0.02, "n_scenes": 256,
               "pool_seed": 0, "kinds": ["checker", "shapes"], "key_seed": 0},
    # chip_smoke.py's warm start
    "warm_start": {"start": "ckpts/flow_086000.msgpack", "steps": 20, "lr": 2e-4, "alpha": 0.02, "n_scenes": 64,
                   "pool_seed": 1, "kinds": ["checker", "shapes"], "key_seed": 1},
}
EVAL_N = 64
EVAL_SEED = 999
EVAL_SETS = {
    "in_family": (["checker", "shapes"], False),
    "perlin": (["perlin"], False),
    "occluders": (["checker", "shapes"], True),
    "perlin_occluders": (["perlin"], True),
}
N_OCC = 3  # `_add_occluders`' default


def flow_config():
    from vstab.core.config import FlowConfig

    return FlowConfig(kernel_impl="xla", compute_dtype="float32")


def load(rel: str):
    from vstab.utils.checkpoint import load_params

    return load_params(os.path.join(REPO, rel))


def scene_pool(n: int, seed: int, kinds) -> np.ndarray:
    from vstab.flow.train import make_scene_pool

    with numpy_drawing():
        return np.asarray(make_scene_pool(n, *HW, seed=seed, kinds=tuple(kinds)))


def pool_digest(pool: np.ndarray, n: int, seed: int, kinds) -> dict:
    return {"call": f"make_scene_pool({n}, {HW[0]}, {HW[1]}, seed={seed}, kinds={tuple(kinds)})",
            "shape": list(pool.shape), "sum": clip_sum(pool), "sample": clip_sample(pool)}


def draws_of(key, n: int, s: int, occluders: bool = True) -> dict:
    """The random numbers `_sample_batch(key, scenes, n, ...)` draws from a
    pool of s scenes, by its own key splits (vstab/flow/train.py:260-330):
    flat numpy arrays, the occluders' stacked over the N_OCC occluders."""
    h, w = HW
    u = lambda k, shape, lo=-1.0, hi=1.0: np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    kidx, kaff, kgrid, kbr, kbl, kocc = jax.random.split(key, 6)
    out = {
        "idx": np.asarray(jax.random.randint(kidx, (n,), 0, s)),
        "blur": np.asarray(jax.random.randint(kbl, (n,), 0, 8)),
        "angle": u(kaff, (n,)),
        "scale": u(jax.random.fold_in(kaff, 1), (n,)),
        "txy": u(jax.random.fold_in(kaff, 2), (n, 2)),
        "coarse": u(kgrid, (n, 4, 5, 2)),
        "gain": u(kbr, (n, 1, 1, 1)),
        "offset": u(jax.random.fold_in(kbr, 1), (n, 1, 1, 1)),
    }
    occ = {f"occ_{k}": [] for k in ("tex", "cy", "cx", "ry", "rx", "move", "on")}
    for j in range(N_OCC if occluders else 0):
        ktex, kgeo, kmove, kon = jax.random.split(jax.random.fold_in(kocc, j), 4)
        occ["occ_tex"].append(np.asarray(jax.random.randint(ktex, (n,), 0, s)))
        occ["occ_cy"].append(u(kgeo, (n,), 0.15 * h, 0.85 * h))
        occ["occ_cx"].append(u(jax.random.fold_in(kgeo, 1), (n,), 0.15 * w, 0.85 * w))
        occ["occ_ry"].append(u(jax.random.fold_in(kgeo, 2), (n,), h / 7.0, h / 3.5))
        occ["occ_rx"].append(u(jax.random.fold_in(kgeo, 3), (n,), w / 7.0, w / 3.5))
        occ["occ_move"].append(u(kmove, (n, 2)))
        occ["occ_on"].append(np.asarray(jax.random.uniform(kon, (n,))))
    if occluders:
        out.update({k: np.stack(v) for k, v in occ.items()})
    return out


def _stack(per_step: list, prefix: str) -> dict:
    """[{name: array}] -> {prefix/name: array stacked over the steps}."""
    return {f"{prefix}/{k}": np.stack([d[k] for d in per_step]) for k in per_step[0]}


def perturb(params, amp: float = TWIN_AMP):
    """Every leaf times (1 + amp * u), u uniform in +-1 from default_rng(0),
    leaf by leaf in `tree_leaves` order."""
    rng = np.random.default_rng(0)
    leaves, tree = jax.tree_util.tree_flatten(params)
    out = [jnp.asarray(np.asarray(l) * (1.0 + amp * rng.uniform(-1.0, 1.0, np.shape(l))).astype(np.float32))
           for l in leaves]
    return jax.tree_util.tree_unflatten(tree, out)


_SAMPLE = {}


def _sampler(occluders: bool = True, blur: bool = True):
    from vstab.flow.train import _sample_batch

    key = (occluders, blur)
    if key not in _SAMPLE:
        _SAMPLE[key] = jax.jit(lambda r, sc: _sample_batch(r, sc, BATCH, MAX_DISP, blur=blur, occluders=occluders))
    return _SAMPLE[key]


def run_steps(params, recipe: dict, pool: np.ndarray, steps: int = None, keep_draws: bool = False, log: str = ""):
    """`steps` (the recipe's by default) supervised steps through a plain
    jax.jit of `make_train_step`, each batch from `_sample_batch` under the
    key `train_fast` would give it, cosine over `steps` to `alpha`.
    Returns (end params, {metric: [per step]}, [draws per step] or None)."""
    import optax

    from vstab.flow.train import make_optimizer, make_train_step

    steps = recipe["steps"] if steps is None else steps
    tx = make_optimizer(optax.cosine_decay_schedule(recipe["lr"], steps, alpha=recipe["alpha"]))
    step = make_train_step(flow_config(), tx, "supervised")
    opt_state = tx.init(params)
    scenes = jnp.asarray(pool)
    rng = jax.random.PRNGKey(recipe["key_seed"])
    hist = {m: [] for m in METRICS}
    draws = [] if keep_draws else None
    t0 = time.perf_counter()
    for k in range(steps):
        rng, sub = jax.random.split(rng)
        if keep_draws:
            draws.append(draws_of(sub, BATCH, pool.shape[0]))
        params, opt_state, ms = step(params, opt_state, _sampler()(sub, scenes))
        for m in METRICS:
            hist[m].append(float(ms[m]))
        if log and (k % 50 == 0 or k == steps - 1):
            print(f"  {log} step {k}: " + json.dumps({m: hist[m][-1] for m in METRICS})
                  + f" ({time.perf_counter() - t0:.0f} s)", flush=True)
    return params, hist, draws


class HeldOut:
    """The held-out pairs of EVAL_SETS: each set's pool, draws and batches
    (made once), and the mean EPE of a network on them by `eval_epe`'s formula."""

    def __init__(self):
        self.pools, self.draws, self.batches = {}, {}, {}
        for name, (kinds, occ) in EVAL_SETS.items():
            pool = scene_pool(8, EVAL_SEED, kinds)
            keys = [jax.random.fold_in(jax.random.PRNGKey(EVAL_SEED), i) for i in range(EVAL_N // BATCH)]
            self.pools[name] = pool
            self.draws[name] = [draws_of(k, BATCH, 8, occ) for k in keys]
            self.batches[name] = [_sampler(occ, blur=False)(k, jnp.asarray(pool)) for k in keys]
        from vstab.flow.pwcnet import estimate_flow

        cfg = flow_config()
        self._flow = jax.jit(lambda p, a, b: estimate_flow(p, a, b, cfg))

    def epe(self, params, name: str) -> dict:
        per = []
        for b in self.batches[name]:
            fl = self._flow(params, b["im1"], b["im2"])
            per.append(float(jnp.mean(jnp.sqrt(jnp.sum((fl - b["flow"]) ** 2, -1) + 1e-12))))
        return {"mean_px": float(np.mean(per)), "per_batch_px": per}

    def epes(self, params) -> dict:
        return {name: self.epe(params, name) for name in EVAL_SETS}


def tolerance(replay: list, twin: list) -> list:
    spread = np.maximum.accumulate(np.abs(np.asarray(twin) - np.asarray(replay)))
    return [float(v) for v in np.maximum(TOL_SPREAD * spread, TOL_REL_FLOOR * np.abs(np.asarray(replay)))]


def train_fast_check(p074, pool: np.ndarray) -> dict:
    """train_fast(..., steps=2, scan_len=2) against the loop of `run_steps`
    over the same two steps (cosine over 2): the chunk mean it prints
    (4 decimals) and its end parameters."""
    from vstab.flow.train import train_fast

    r = RECIPES["replay"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with numpy_drawing(), contextlib.redirect_stdout(buf):
        fast = train_fast(flow_config(), steps=2, batch_size=BATCH, hw=HW, lr=r["lr"], seed=r["key_seed"],
                          params=p074, scan_len=2, n_scenes=r["n_scenes"], max_disp=MAX_DISP, ckpt_dir=None,
                          kinds=tuple(r["kinds"]))
    fast_s = time.perf_counter() - t0
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step ")][-1]
    printed = json.loads(line.split(": ", 1)[1].replace("'", '"'))
    loop, hist, _ = run_steps(p074, r, pool, steps=2)
    mean = {m: float(np.mean(hist[m])) for m in printed}
    diff = {m: abs(printed[m] - round(mean[m], 4)) for m in printed}
    param_diff = max(float(jnp.abs(a - b).max()) for a, b in
                     zip(jax.tree_util.tree_leaves(fast), jax.tree_util.tree_leaves(loop)))
    return {"train_fast_printed": printed, "loop_mean": mean, "loop_steps": hist,
            "abs_diff_of_printed_and_rounded_loop_mean": diff, "limit": 1e-5,
            "passes": all(v <= 1e-5 for v in diff.values()),
            "end_params_max_abs_diff": param_diff, "train_fast_s": fast_s,
            "rule": "train_fast prints each chunk's mean to 4 decimals; the loop's mean of the same 2 steps, "
                    "rounded alike, must equal it to 1e-5"}


def write() -> None:
    import cv2
    import optax

    t_start = time.perf_counter()
    doc = {
        "about": "The JAX package's training readings on the CPU (kernel_impl='xla', f32), the reference of the "
                 "port's trainer. Written by `JAX_PLATFORMS=cpu python tests/torch_train_reference.py --write`; "
                 "see that file's docstring. The draws are in torch_train_reference.npz.",
        "partial": True,
        "settings": {
            "recipes": RECIPES, "batch": BATCH, "hw": list(HW), "max_disp": MAX_DISP, "blur": True,
            "occluders": True, "n_occluders": N_OCC, "mode": "supervised",
            "flow_config": "FlowConfig(kernel_impl='xla', compute_dtype='float32'), default widths",
            "optimizer": "make_optimizer(optax.cosine_decay_schedule(lr, steps, alpha=alpha)): clip_by_global_norm"
                         "(1.0) then adamw(weight_decay=4e-4)",
            "step": "jax.jit of make_train_step(cfg, tx, 'supervised'); batches from jax.jit of _sample_batch("
                    "sub, scenes, 8, 12.0) (blur and occluders on)",
            "keys": "rng = PRNGKey(key_seed); before each step rng, sub = split(rng); the batch's key is sub "
                    "(vstab/flow/train.py:355, :380-382)",
            "twin": f"the replay from every start leaf times (1 + {TWIN_AMP:g} u), u uniform in +-1 from "
                    "numpy.random.default_rng(0), leaf by leaf in jax.tree_util.tree_leaves order",
            "tolerance_rule": f"per metric at step k: max({TOL_SPREAD:g} * max over j <= k of |twin_j - replay_j|, "
                              f"{TOL_REL_FLOOR:g} * |replay_k|)",
            "epe_tolerance_rule": f"of an end EPE: max({TOL_SPREAD:g} * |twin - replay|, {EPE_TOL_FLOOR:g} px)",
            "held_out": {"n": EVAL_N, "seed": EVAL_SEED, "sets": EVAL_SETS, "blur": False,
                         "keys": f"batch i under fold_in(PRNGKey({EVAL_SEED}), i), i < {EVAL_N // BATCH}",
                         "pool": f"make_scene_pool(8, {HW[0]}, {HW[1]}, seed={EVAL_SEED}, kinds)",
                         "epe": "per batch mean(sqrt(sum((flow - gt)^2, -1) + 1e-12)) of estimate_flow, then the "
                                "mean over the batches (eval_epe's formula)"},
            "npz": {"draws": "<run>/<name> stacked over the steps ([steps, 8, ...]; occluders [steps, 3, 8, ...]), "
                             "held/<set>/<name> stacked over the batches",
                    "names": "idx, blur, angle, scale, txy, coarse, gain, offset in +-1 (blur 0..7, idx and "
                             "occ_tex scene indices); occ_tex, occ_cy, occ_cx, occ_ry, occ_rx (pixels), occ_move "
                             "(+-1), occ_on ([0, 1))"},
            "drawing": "every pool by the generator's numpy paths, OpenCV hidden while it draws; sum in float64, "
                       "sample: 64 values at places drawn from numpy.random.default_rng(0)",
            "platform": "cpu", "jax": jax.__version__, "optax": optax.__version__, "numpy": np.__version__,
            "cv2": cv2.__version__, "python": sys.version.split()[0],
        },
        "wall_s": {},
    }
    arrays = {}

    def flush():
        doc["wall_s"]["total_s"] = time.perf_counter() - t_start
        with open(JSON_PATH, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        np.savez_compressed(NPZ_PATH, **arrays)
        print(f"  wrote {sorted(k for k in doc if k not in ('about', 'settings'))} "
              f"({doc['wall_s']['total_s']:.0f} s)", flush=True)

    t0 = time.perf_counter()
    held = HeldOut()
    p074, p086 = load(RECIPES["replay"]["start"]), load(RECIPES["warm_start"]["start"])
    pools = {run: scene_pool(r["n_scenes"], r["pool_seed"], r["kinds"]) for run, r in RECIPES.items()}
    doc["pools"] = {run: pool_digest(pools[run], r["n_scenes"], r["pool_seed"], r["kinds"])
                    for run, r in RECIPES.items()}
    doc["pools"].update({f"held/{name}": pool_digest(held.pools[name], 8, EVAL_SEED, kinds)
                         for name, (kinds, _) in EVAL_SETS.items()})
    for name in EVAL_SETS:
        arrays.update(_stack(held.draws[name], f"held/{name}"))
    doc["held_out"] = {"flow_074000": held.epes(p074)}
    doc["wall_s"]["held_out_s"] = time.perf_counter() - t0
    flush()

    t0 = time.perf_counter()
    end, hist, draws = run_steps(p074, RECIPES["replay"], pools["replay"], keep_draws=True, log="replay")
    arrays.update(_stack(draws, "replay"))
    doc["replay"] = hist
    doc["held_out"]["replay_end"] = held.epes(end)
    doc["wall_s"]["replay_s"] = time.perf_counter() - t0
    flush()

    t0 = time.perf_counter()
    twin_end, twin, _ = run_steps(perturb(p074), RECIPES["replay"], pools["replay"], log="twin")
    doc["twin"] = twin
    doc["tolerance"] = {m: tolerance(hist[m], twin[m]) for m in METRICS}
    doc["held_out"]["twin_end"] = held.epes(twin_end)
    doc["epe_tolerance"] = {
        name: max(TOL_SPREAD * abs(doc["held_out"]["twin_end"][name]["mean_px"]
                                   - doc["held_out"]["replay_end"][name]["mean_px"]), EPE_TOL_FLOOR)
        for name in EVAL_SETS}
    doc["wall_s"]["twin_s"] = time.perf_counter() - t0
    flush()

    t0 = time.perf_counter()
    warm_end, warm, warm_draws = run_steps(p086, RECIPES["warm_start"], pools["warm_start"], keep_draws=True,
                                           log="warm start")
    arrays.update(_stack(warm_draws, "warm_start"))
    doc["warm_start"] = {**warm, "held_out_before": held.epes(p086), "held_out_after": held.epes(warm_end)}
    doc["wall_s"]["warm_start_s"] = time.perf_counter() - t0
    flush()

    t0 = time.perf_counter()
    doc["train_fast_check"] = train_fast_check(p074, pools["replay"])
    doc["wall_s"]["train_fast_check_s"] = time.perf_counter() - t0
    doc["partial"] = False
    flush()
    print(json.dumps(doc["train_fast_check"]), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(f"usage: JAX_PLATFORMS=cpu python {sys.argv[0]} --write")
    write()
    print(f"wrote {JSON_PATH} and {NPZ_PATH}")
