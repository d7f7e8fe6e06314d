"""The JAX package's own quality readings, which the port is held to.

    JAX_PLATFORMS=cpu python tests/torch_quality_reference.py --write

writes `tests/torch_quality_reference.json`. Only the JAX package can
write it, on the CPU (kernel_impl="xla"), and it does not change unless the
JAX package does. A test helper, not collected by pytest: it imports `vstab`
(and nothing of `vstab_torch`); the port, `chip_smoke.py` among it, only
reads the JSON. The tests import it to recompute two entries live.

What it holds, with every setting beside the numbers:

- spread: stability, cropping and distortion of the dynamic gate clip (the
  clip of tests/integration/test_dynamic.py) and of synthetic_001 at
  48x256x320, each under K input-noise draws (uniform +-1e-4,
  numpy.random.default_rng(k) for k < K, clipped to [0, 1]), with f32 and
  with bf16 flow; sigma of each score is the pooled per-clip standard
  deviation of the two clips;
- N, the size of the eval set, and the tolerances, both from sigma alone
  (`tolerance`, `choose_n`);
- eval_set: the three scores of `synthetic_clip_set(N)` at 48x256x320,
  default Config, f32 and bf16 flow, and the bf16 flow's distance from the
  f32 flow on two of its clips;
- hd720: three 48x720x1280 clips in f32;
- gates: every clip and Config of tests/integration/test_synthetic.py,
  test_trained.py and test_dynamic.py under the K draws and noiseless (f32
  flow), the inputs' own scores, the path deviation, and each gate of those
  tests with the reference's mean over the draws;
- epe: the three `eval_epe` readings of test_trained.py;
- opencv_dynamic: the two runs of test_dynamic.py on its clip as that test
  draws it where OpenCV is installed (the installed OpenCV, named beside),
  noiseless and under the K draws, and the gates they read.

Every other clip, and every held-out scene of the EPE readings, is drawn by
the generator's numpy paths (OpenCV hidden while it draws): OpenCV's drawing depends on its version, and a machine with
another OpenCV would draw other clips (4.13 against 5.0: up to 3/255 on a
tenth of the values). Each clip's sum and 64 of its values are kept, so that
a port can show that it drew the same clips.
"""

from __future__ import annotations

import copy
import json
import math
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")  # as tests/conftest.py

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
JSON_PATH = os.path.join(HERE, "torch_quality_reference.json")
REPO = os.path.dirname(HERE)
if REPO not in sys.path:  # run as a script from tests/
    sys.path.insert(0, REPO)

K = 8  # input-noise draws
NOISE_AMP = 1e-4
SCORES = ("stability", "cropping", "distortion")
DTYPES = ("float32", "bfloat16")
EVAL_SHAPE = (48, 256, 320)
GATE_SHAPE = (48, 160, 192)
HD720_SEEDS = (0, 1, 2)
CPU_SUBSET = 12  # the eval set's clips the CPU tests run
STAB_TOL_TARGET = 0.03  # f32 stability tolerance of the whole set's mean
CROP_TOL_FLOOR = 5e-3
FLOW_PARITY_CLIPS = (1, 2)  # clips of the eval set whose bf16 flow is held

# Config overrides on the default Config; every run's flow uses the XLA
# formulation on the CPU and the dtype it is run in.
_FIXED_08 = {"render": {"crop_mode": "fixed", "fixed_crop_ratio": 0.8}}
_GATE_FLOW = {"flow": {"compute_dtype": "float32", "kernel_impl": "xla"}}

# The gate clips, by name: (function of vstab.eval.synthetic, keyword arguments).
GATE_CLIPS = {
    "shaky_seed3": ("make_shaky_clip", {"t": 48, "h": 160, "w": 192, "seed": 3}),
    "perlin_seed4": ("make_shaky_clip", {"t": 48, "h": 160, "w": 192, "seed": 4, "scene_kind": "perlin"}),
    "dynamic_seed3": ("make_dynamic_clip", {"t": 48, "h": 160, "w": 192, "seed": 3}),
}

# The gate runs: the clip, where its flow comes from ("net": the trained
# network through `stabilize`; "analytic": the clip's known camera path
# through `smooth_and_render`), the Config overrides, and the test it mirrors.
GATE_RUNS = {
    "synthetic_affine": ("shaky_seed3", "analytic", {"smooth": {"method": "affine"}, **_FIXED_08},
                         "tests/integration/test_synthetic.py:30"),
    "synthetic_sparse_ls": ("shaky_seed3", "analytic", {"smooth": {"method": "sparse_ls"}, **_FIXED_08},
                            "tests/integration/test_synthetic.py:30"),
    "trained_affine": ("shaky_seed3", "net", {"smooth": {"method": "affine"}, **_FIXED_08, **_GATE_FLOW},
                       "tests/integration/test_trained.py:46"),
    "trained_sparse_ls": ("shaky_seed3", "net", {"smooth": {"method": "sparse_ls"}, **_FIXED_08, **_GATE_FLOW},
                          "tests/integration/test_trained.py:46"),
    "perlin_sparse_ls": ("perlin_seed4", "net", {"smooth": {"method": "sparse_ls"}, **_FIXED_08, **_GATE_FLOW},
                         "tests/integration/test_trained.py:63"),
    "dynamic_robust2": ("dynamic_seed3", "net",
                        {"smooth": {"robust_iters": 2}, "render": {"crop_mode": "fixed", "fixed_crop_ratio": 0.8,
                                                                   "kernel_impl": "xla"}, **_GATE_FLOW},
                        "tests/integration/test_dynamic.py:53"),
    "dynamic_robust0": ("dynamic_seed3", "net",
                        {"smooth": {"robust_iters": 0}, "render": {"crop_mode": "fixed", "fixed_crop_ratio": 0.8,
                                                                   "kernel_impl": "xla"}, **_GATE_FLOW},
                        "tests/integration/test_dynamic.py:53"),
}
# The inputs whose own scores a margin gate subtracts.
INPUT_CLIPS = ("shaky_seed3", "perlin_seed4")
# test_dynamic.py:68-78: mean |path(dynamic) - path(shaky)| under this run's Config.
PATH_DEVIATION_RUN = "dynamic_robust2"
# The runs of `opencv_dynamic`, on the OpenCV-drawn dynamic gate clip.
OPENCV_RUNS = ("dynamic_robust2", "dynamic_robust0")

# Each gate of the JAX package's integration tests: value = (mean over the
# draws of) run.score, less `minus` (a run, or "input:<clip>") where given.
GATES = [
    *[g for m in ("affine", "sparse_ls") for g in (
        {"name": f"synthetic_{m} stability", "run": f"synthetic_{m}", "score": "stability", "op": ">",
         "threshold": 0.85},
        {"name": f"synthetic_{m} stability gain", "run": f"synthetic_{m}", "score": "stability",
         "minus": "input:shaky_seed3", "op": ">", "threshold": 0.25},
        {"name": f"synthetic_{m} cropping", "run": f"synthetic_{m}", "score": "cropping", "op": ">",
         "threshold": 0.75},
        {"name": f"synthetic_{m} distortion", "run": f"synthetic_{m}", "score": "distortion", "op": ">",
         "threshold": 0.95},
    )],
    {"name": "trained_sparse_ls stability", "run": "trained_sparse_ls", "score": "stability", "op": ">",
     "threshold": 0.8},
    {"name": "trained_sparse_ls stability gain", "run": "trained_sparse_ls", "score": "stability",
     "minus": "input:shaky_seed3", "op": ">", "threshold": 0.15},
    {"name": "trained_sparse_ls distortion", "run": "trained_sparse_ls", "score": "distortion", "op": ">",
     "threshold": 0.9},
    {"name": "trained_affine stability", "run": "trained_affine", "score": "stability", "op": ">",
     "threshold": 0.75},
    {"name": "trained_affine stability gain", "run": "trained_affine", "score": "stability",
     "minus": "input:shaky_seed3", "op": ">", "threshold": 0.10},
    {"name": "trained_affine distortion", "run": "trained_affine", "score": "distortion", "op": ">",
     "threshold": 0.9},
    {"name": "perlin_sparse_ls stability", "run": "perlin_sparse_ls", "score": "stability", "op": ">",
     "threshold": 0.65},
    {"name": "perlin_sparse_ls stability gain", "run": "perlin_sparse_ls", "score": "stability",
     "minus": "input:perlin_seed4", "op": ">", "threshold": 0.4},
    {"name": "dynamic_robust2 stability", "run": "dynamic_robust2", "score": "stability", "op": ">",
     "threshold": 0.75},
    {"name": "dynamic robust over mean pooling", "run": "dynamic_robust2", "score": "stability",
     "minus": "dynamic_robust0", "op": ">", "threshold": 0.05},
    {"name": "dynamic path deviation px", "run": "path_deviation", "score": "px", "op": "<", "threshold": 4.0},
]
_GATE_SOURCES = {
    "synthetic": "tests/integration/test_synthetic.py:39-42",
    "trained": "tests/integration/test_trained.py:54-60",
    "perlin": "tests/integration/test_trained.py:77-78",
    "dynamic_robust2 stability": "tests/integration/test_dynamic.py:61",
    "dynamic robust": "tests/integration/test_dynamic.py:65",
    "dynamic path": "tests/integration/test_dynamic.py:78",
}
EPE_GATES = [  # tests/integration/test_trained.py:81-101, at hw (192, 256), n = 8
    {"name": "in family", "kinds": ["checker", "shapes"], "occluders": False, "threshold": 1.2},
    {"name": "perlin", "kinds": ["perlin"], "occluders": False, "threshold": 1.0},
    {"name": "occluders", "kinds": ["checker", "shapes"], "occluders": True, "threshold": 2.2},
]


def tolerance(sigma: float, n: int, score: str) -> float:
    """Of the mean of a score over n clips: 3 * sqrt(2) * sigma / sqrt(n);
    for cropping at least 5e-3."""
    tol = 3.0 * math.sqrt(2.0) * sigma / math.sqrt(n)
    return max(tol, CROP_TOL_FLOOR) if score == "cropping" else tol


def choose_n(sigma_stability_f32: float) -> int:
    """The smallest multiple of 12 (the CPU tests run the first 12 clips, a
    third of 36) whose f32 stability tolerance is at most 0.03."""
    n = CPU_SUBSET
    while tolerance(sigma_stability_f32, n, "stability") > STAB_TOL_TARGET:
        n += CPU_SUBSET
    return n


def noisy(frames: np.ndarray, k: int) -> np.ndarray:
    """Draw k of the input noise: uniform +-1e-4 from default_rng(k), clipped."""
    noise = np.random.default_rng(k).uniform(-NOISE_AMP, NOISE_AMP, frames.shape).astype(np.float32)
    return np.clip(frames + noise, 0.0, 1.0)


def draws(frames: np.ndarray):
    """(None, frames) for the noiseless reading, then (k, noisy(frames, k))."""
    yield None, frames
    for k in range(K):
        yield k, noisy(frames, k)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for key, val in over.items():
        out[key] = _merge(out.get(key, {}), val) if isinstance(val, dict) else val
    return out


def config(overrides: dict, dtype: str = None):
    """The JAX Config of a run: overrides on the default Config, flow in the
    XLA formulation and `dtype` where given."""
    from vstab.core.config import Config

    over = _merge(overrides, {"flow": {"kernel_impl": "xla", **({"compute_dtype": dtype} if dtype else {})},
                              "render": {"kernel_impl": "xla"}})
    return Config.from_json(json.dumps(_merge(json.loads(Config().to_json()), over)))


class numpy_drawing:
    """Hides OpenCV from the JAX package's generator while it draws, so that
    it takes its numpy paths (the same on every machine)."""

    def __enter__(self):
        self.saved = sys.modules.get("cv2")
        sys.modules["cv2"] = None

    def __exit__(self, *exc):
        if self.saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = self.saved


def gate_clip(name: str):
    import vstab.eval.synthetic as syn

    fn, kw = GATE_CLIPS[name]
    with numpy_drawing():
        return getattr(syn, fn)(**kw)


def eval_clips(n: int):
    """synthetic_clip_set(n) at EVAL_SHAPE, drawn by the numpy paths."""
    from vstab.eval.deepstab import synthetic_clip_set

    with numpy_drawing():
        return synthetic_clip_set(n, *EVAL_SHAPE)


def hd720_clip(seed: int) -> np.ndarray:
    from vstab.eval.synthetic import make_shaky_clip

    with numpy_drawing():
        return make_shaky_clip(t=48, h=720, w=1280, seed=seed)[0]


def clip_sum(frames: np.ndarray) -> float:
    return float(np.asarray(frames, np.float64).sum())


def clip_sample(frames: np.ndarray) -> list:
    """64 of the clip's values at places drawn from default_rng(0)."""
    idx = np.random.default_rng(0).integers(0, frames.size, 64)
    return [float(v) for v in np.asarray(frames).reshape(-1)[idx]]


_PARAMS = {}


def params():
    from vstab.pipeline import default_params

    if "p" not in _PARAMS:
        _PARAMS["p"] = default_params(config({}), ckpt_dir=os.path.join(REPO, "ckpts"))
    return _PARAMS["p"]


def clip_flow_of(frames, dtype: str):
    """The eval set's flow of a clip: default Config, `dtype` flow."""
    from vstab.pipeline import clip_flow

    return clip_flow(params(), frames, config({}, dtype))


def stabilize_from_flow(frames, flow, cfg):
    """`vstab.pipeline.stabilize` given the clip's flow (which depends only on
    cfg.flow, so runs that differ in smoothing or render share it)."""
    from vstab.pipeline import path_to_flow, smooth_paths
    from vstab.render.render import pick_max_disp, render_stabilized, residual_disp_bound

    t, h, w, _ = frames.shape
    path, _ = smooth_paths(flow, cfg, (h, w))
    bound = residual_disp_bound(np.asarray(path), h, w, cfg.smooth.method)
    d = pick_max_disp(bound, cfg.render)
    return render_stabilized(frames, path_to_flow(path, cfg, (h, w)), cfg.render, max_disp=d)


def scores(inp: np.ndarray, out) -> dict:
    from vstab.eval.metrics import evaluate_videos

    return evaluate_videos(inp, np.asarray(out))


def stabilize_scores(frames: np.ndarray, cfg) -> dict:
    """`vstab.pipeline.stabilize` on one clip, then its three scores."""
    from vstab.pipeline import stabilize

    out, _ = stabilize(jnp.asarray(frames), params(), cfg)
    return scores(frames, out)


def _mean(recs) -> dict:
    return {k: float(np.mean([r[k] for r in recs])) for k in recs[0]}


def _std(recs) -> dict:
    return {k: float(np.std([r[k] for r in recs], ddof=1)) for k in recs[0]}


def _analytic_flow(cams, h, w):
    from vstab.core.types import compose_affine, invert_affine
    from vstab.render.render import affine_to_flow

    cams = jnp.asarray(cams)
    return affine_to_flow(compose_affine(invert_affine(cams[1:]), cams[:-1]), h, w)


def gate_readings(dtype: str = "float32") -> dict:
    """Every gate run, the inputs' scores and the path deviation, noiseless
    and under each draw, with `dtype` flow."""
    from vstab.pipeline import clip_flow, smooth_and_render, smooth_paths

    runs = {name: {"noiseless": None, "draws": []} for name in GATE_RUNS}
    inputs = {name: {"noiseless": None, "draws": []} for name in INPUT_CLIPS}
    dev = {"noiseless": None, "draws": []}
    clips = {name: gate_clip(name) for name in GATE_CLIPS}
    h, w = GATE_SHAPE[1:]
    analytic = _analytic_flow(clips["shaky_seed3"][1], h, w)
    for k in [None, *range(K)]:
        put = (lambda rec, v: rec.__setitem__("noiseless", v)) if k is None else (lambda rec, v: rec["draws"].append(v))
        frames = {name: (f if k is None else noisy(f, k)) for name, (f, _) in clips.items()}
        flows = {}
        for name, (clip, src, over, _) in GATE_RUNS.items():
            cfg = config(over, dtype)
            fr = jnp.asarray(frames[clip])
            if src == "analytic":
                out, _ = smooth_and_render(fr, analytic, cfg)
            else:
                if clip not in flows:
                    flows[clip] = clip_flow(params(), fr, cfg)
                out = stabilize_from_flow(fr, flows[clip], cfg)
            put(runs[name], scores(frames[clip], out))
        for name in INPUT_CLIPS:
            put(inputs[name], scores(frames[name], frames[name]))
        cfg = config(GATE_RUNS[PATH_DEVIATION_RUN][2], dtype)
        pd, _ = smooth_paths(flows["dynamic_seed3"], cfg, (h, w))
        ps, _ = smooth_paths(flows["shaky_seed3"], cfg, (h, w))
        put(dev, {"px": float(jnp.abs(pd - ps).mean())})
        print(f"  gates {dtype} draw {k}: " + json.dumps({n: r["noiseless"] if k is None else r["draws"][-1]
                                                        for n, r in runs.items()}), flush=True)
    for rec in (*runs.values(), *inputs.values(), dev):
        rec["mean"] = _mean(rec["draws"])
    return {"runs": runs, "inputs": inputs, "path_deviation": dev}


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


def clears(gate: dict, value: float) -> bool:
    return value > gate["threshold"] if gate["op"] == ">" else value < gate["threshold"]


def gate_entries(readings: dict, gates=GATES) -> list:
    """Each gate with its source and the reference's mean and noiseless
    reading from `readings`, and whether its mean clears it."""
    out = []
    for g in gates:
        src = next(v for k, v in _GATE_SOURCES.items() if g["name"].startswith(k))
        mean = gate_value(g, readings)
        out.append({**g, "source": src, "reference_mean": mean,
                    "reference_noiseless": gate_value(g, readings, "noiseless"), "reference_clears": clears(g, mean)})
    return out


def opencv_dynamic() -> dict:
    """The dynamic gate clip as tests/integration/test_dynamic.py draws it
    where OpenCV is installed (the JAX package's generator, OpenCV not
    hidden), through the two runs of that test, noiseless and under the K
    draws, f32 flow; and the gates of those runs alone."""
    import cv2
    from vstab.eval.synthetic import make_dynamic_clip
    from vstab.pipeline import clip_flow

    fn, kw = GATE_CLIPS["dynamic_seed3"]
    assert fn == "make_dynamic_clip"
    frames, _ = make_dynamic_clip(**kw)
    runs = {name: {"noiseless": None, "draws": []} for name in OPENCV_RUNS}
    for k, fr in draws(frames):
        jfr = jnp.asarray(fr)
        flow = clip_flow(params(), jfr, config(GATE_RUNS[OPENCV_RUNS[0]][2], "float32"))
        for name in OPENCV_RUNS:
            got = scores(fr, stabilize_from_flow(jfr, flow, config(GATE_RUNS[name][2], "float32")))
            if k is None:
                runs[name]["noiseless"] = got
            else:
                runs[name]["draws"].append(got)
        print(f"  opencv_dynamic draw {k}: " + json.dumps({n: r["noiseless"] if k is None else r["draws"][-1]
                                                         for n, r in runs.items()}), flush=True)
    for rec in runs.values():
        rec["mean"] = _mean(rec["draws"])
    readings = {"runs": runs, "inputs": {}}
    gates = [g for g in GATES if {g["run"], g.get("minus", g["run"])} <= set(OPENCV_RUNS)]
    return {"clip": "dynamic_seed3", "cv2": cv2.__version__,
            "drawing": "the JAX package's generator with OpenCV (as tests/integration/test_dynamic.py draws it "
                       "where OpenCV is installed); another OpenCV version draws another clip",
            "clip_sum": clip_sum(frames), "clip_sample": clip_sample(frames), "float32": readings,
            "gates": gate_entries(readings, gates)}


def _still_clip() -> dict:
    """test_synthetic.py:46-58 and 61-67: the still clip's largest change and
    the output's range (no draws: these are not scores)."""
    from vstab.eval.synthetic import checker_scene
    from vstab.pipeline import smooth_and_render

    scene = checker_scene(96, 128, seed=1)
    frames = jnp.broadcast_to(scene, (12, 96, 128, 3))
    out, _ = smooth_and_render(frames, jnp.zeros((11, 96, 128, 2)),
                               config({"smooth": {"method": "sparse_ls"}, "render": {"crop_mode": "none"}}))
    clip, cams = gate_clip("shaky_seed3")
    out2, _ = smooth_and_render(jnp.asarray(clip), _analytic_flow(cams, *GATE_SHAPE[1:]),
                                config({"smooth": {"method": "sparse_ls"}}))
    return {"still_clip_max_abs_change": float(jnp.abs(out - frames).max()),
            "still_clip_tolerance": 1e-2,
            "output_range": [float(out2.min()), float(out2.max())], "output_range_slack": 1e-4}


def flow_distance(a, b) -> dict:
    """Mean end-point distance of two flows [.., 2] and the share over 0.5 px."""
    d = np.sqrt(np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2, -1))
    return {"mean_px": float(d.mean()), "share_over_half_px": float((d > 0.5).mean()), "max_px": float(d.max())}


def eval_set(n: int) -> dict:
    """The three scores of each clip of synthetic_clip_set(n), f32 and bf16
    flow, and the bf16 flow's distance from the f32 flow on two clips."""
    from vstab.pipeline import clip_flow

    clips = eval_clips(n)
    out = {"clips": [name for name, _ in clips], "clip_sums": [clip_sum(f) for _, f in clips],
           "clip_samples": [clip_sample(f) for _, f in clips], "float32": [], "bfloat16": [], "bf16_flow_vs_f32": {}}
    for i, (name, frames) in enumerate(clips):
        flows = {}
        for dtype in DTYPES:
            cfg = config({}, dtype)
            fr = jnp.asarray(frames)
            flows[dtype] = clip_flow(params(), fr, cfg)
            out[dtype].append(scores(frames, stabilize_from_flow(fr, flows[dtype], cfg)))
        if i in FLOW_PARITY_CLIPS:
            out["bf16_flow_vs_f32"][name] = flow_distance(flows["bfloat16"], flows["float32"])
        print(f"  eval set {name}: " + json.dumps({d: out[d][-1] for d in DTYPES}), flush=True)
    out["means"] = {d: {"all": _mean(out[d]), f"first_{CPU_SUBSET}": _mean(out[d][:CPU_SUBSET])} for d in DTYPES}
    return out


def spread_synthetic_001() -> dict:
    """synthetic_001 of the eval set under the K draws, f32 and bf16."""
    frames = eval_clips(2)[1][1]
    out = {}
    for dtype in DTYPES:
        cfg = config({}, dtype)
        recs = {"noiseless": None, "draws": []}
        for k, fr in draws(frames):
            s = stabilize_scores(fr, cfg)
            if k is None:
                recs["noiseless"] = s
            else:
                recs["draws"].append(s)
        recs["mean"], recs["std"] = _mean(recs["draws"]), _std(recs["draws"])
        out[dtype] = recs
        print(f"  spread synthetic_001 {dtype}: " + json.dumps(recs["std"]), flush=True)
    return out


def hd720() -> dict:
    cfg = config({}, "float32")
    recs, sums, samples = [], [], []
    for s in HD720_SEEDS:
        frames = hd720_clip(s)
        sums.append(clip_sum(frames))
        samples.append(clip_sample(frames))
        recs.append(stabilize_scores(frames, cfg))
        print(f"  720p seed {s}: " + json.dumps(recs[-1]), flush=True)
    return {"clips": [f"make_shaky_clip(t=48, h=720, w=1280, seed={s})" for s in HD720_SEEDS],
            "seeds": list(HD720_SEEDS), "clip_sums": sums, "clip_samples": samples, "float32": recs,
            "mean": _mean(recs)}


def epe() -> list:
    from vstab.core.config import FlowConfig
    from vstab.flow.train import eval_epe
    from vstab.utils.checkpoint import latest_checkpoint, load_params

    p = load_params(latest_checkpoint(os.path.join(REPO, "ckpts")))
    cfg = FlowConfig(kernel_impl="xla", compute_dtype="float32")
    with numpy_drawing():  # the held-out scenes, as every other clip here
        return [{**g, "epe_px": float(eval_epe(p, cfg, hw=(192, 256), n=8, kinds=tuple(g["kinds"]),
                                               occluders=g["occluders"]))} for g in EPE_GATES]


def write() -> dict:
    import cv2

    t_start = time.perf_counter()
    wall = {}

    t0 = time.perf_counter()
    gates_f32 = gate_readings("float32")
    gates_bf16 = gate_readings("bfloat16")
    wall["gates_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    syn1 = spread_synthetic_001()
    wall["spread_synthetic_001_s"] = time.perf_counter() - t0

    dyn = {d: g["runs"]["dynamic_robust2"] for d, g in (("float32", gates_f32), ("bfloat16", gates_bf16))}
    for rec in dyn.values():
        rec["std"] = _std(rec["draws"])
    spread = {"dynamic_seed3": {"run": "dynamic_robust2", **dyn}, "synthetic_001": syn1}
    sigma = {d: {s: float(math.sqrt(np.mean([spread[c][d]["std"][s] ** 2 for c in spread]))) for s in SCORES}
             for d in DTYPES}
    n = choose_n(sigma["float32"]["stability"])
    sizes = sorted({n, CPU_SUBSET, len(HD720_SEEDS), K})
    tol = {d: {str(m): {s: tolerance(sigma[d][s], m, s) for s in SCORES} for m in sizes} for d in DTYPES}
    print("sigma " + json.dumps(sigma) + f" N {n}", flush=True)

    t0 = time.perf_counter()
    ev = eval_set(n)
    wall["eval_set_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hd = hd720()
    wall["hd720_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ep = epe()
    wall["epe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cv_dyn = opencv_dynamic()
    wall["opencv_dynamic_s"] = time.perf_counter() - t0

    gates = gate_entries(gates_f32)
    wall["total_s"] = time.perf_counter() - t_start
    doc = {
        "about": "The JAX package's quality readings on the CPU (kernel_impl='xla'), the port's reference. "
                 "Written by `JAX_PLATFORMS=cpu python tests/torch_quality_reference.py --write`; "
                 "see that file's docstring.",
        "settings": {
            "K": K, "noise": f"uniform +-{NOISE_AMP:g} from numpy.random.default_rng(k), k < K, added to the f32 "
                             "frames and clipped to [0, 1]",
            "eval_shape": list(EVAL_SHAPE), "gate_shape": list(GATE_SHAPE), "gate_clips": GATE_CLIPS,
            "gate_runs": {k: {"clip": c, "flow": src, "config": over, "mirrors": m}
                          for k, (c, src, over, m) in GATE_RUNS.items()},
            "gate_clip_sums": {name: clip_sum(gate_clip(name)[0]) for name in GATE_CLIPS},
            "gate_clip_samples": {name: clip_sample(gate_clip(name)[0]) for name in GATE_CLIPS},
            "drawing": "every clip by the generator's numpy paths, OpenCV hidden while it draws (OpenCV's drawing "
                       "depends on its version); clip_sums: each clip's sum in float64; clip_samples: 64 of its "
                       "values at places drawn from numpy.random.default_rng(0)",
            "input_clips": list(INPUT_CLIPS), "path_deviation_run": PATH_DEVIATION_RUN,
            "config_rule": "each run's Config is the default Config with its overrides, kernel_impl 'xla' for the "
                           "flow and the render, and the flow's compute_dtype of the reading",
            "platform": "cpu", "xla_flags": os.environ.get("XLA_FLAGS"), "jax": jax.__version__,
            "numpy": np.__version__, "cv2": cv2.__version__, "python": sys.version.split()[0],
        },
        "wall_s": wall,
        "spread": spread,
        "sigma": sigma,
        "sigma_rule": "per score and precision, the root mean square of the two spread clips' standard deviations "
                      "(ddof 1) over the K draws",
        "N": n,
        "N_rule": f"the smallest multiple of {CPU_SUBSET} whose f32 stability tolerance is at most "
                  f"{STAB_TOL_TARGET}, chosen from sigma before any port number was read",
        "tolerance_rule": "for the mean of a score over n clips (or n draws of one clip): 3 * sqrt(2) * sigma / "
                          f"sqrt(n), per precision; for cropping at least {CROP_TOL_FLOOR:g}",
        "tolerance": tol,
        "eval_set": ev,
        "hd720": hd,
        "gates": {"float32": gates_f32, "bfloat16": gates_bf16, "list": gates, **_still_clip()},
        "epe": ep,
        "opencv_dynamic": cv_dyn,
    }
    return doc


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(f"usage: JAX_PLATFORMS=cpu python {sys.argv[0]} --write")
    document = write()
    with open(JSON_PATH, "w") as f:
        json.dump(document, f, indent=1)
        f.write("\n")
    print(f"wrote {JSON_PATH} in {document['wall_s']['total_s']:.0f} s")
