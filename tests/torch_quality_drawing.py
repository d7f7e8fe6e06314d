"""Where a machine's quality readings can part from the reference's: the
clips it draws, or the tracker that scores them.

    JAX_PLATFORMS=cpu python tests/torch_quality_drawing.py --write DIR
    python tests/torch_quality_drawing.py --check DIR

`--write` runs on the machine that wrote `tests/torch_quality_reference.json`,
with the JAX package (a test helper, not collected by pytest). It keeps in
DIR: a digest of every quality clip drawn by the generator's OpenCV paths
and by its numpy paths, synthetic_001 as drawn by OpenCV (uint8), and three
(input, output) pairs of the JAX package's f32 pipeline as uint8 with their
scores. `--check` runs anywhere the port runs (a card is not needed, JAX
is not): it draws the OpenCV clips with the JAX package's generator,
`vstab/eval/synthetic.py`, loaded from its file (numpy and OpenCV, nothing
of JAX), and the numpy clips with the port's. It prints one JSON object:
which clips are drawn differently there by each path, how far synthetic_001
moves (share of uint8 values and largest step), the scores of the shipped
pairs there against DIR's (uint8 frames reach the tracker unchanged), and
the share of uint8 values that one input-noise draw flips.
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:  # run as a script from tests/
    sys.path.insert(0, REPO)

PAIRS = (1, 2, 31)  # eval-set clips whose JAX outputs are shipped


def _u8(frames) -> np.ndarray:
    return (np.clip(np.asarray(frames), 0, 1) * 255).astype(np.uint8)


def _digest(frames) -> str:
    return hashlib.sha256(np.ascontiguousarray(frames).tobytes()).hexdigest()[:16]


def _clip_set(synthetic, n: int, t: int, h: int, w: int):
    """`synthetic_clip_set(n)` (the same in both packages) drawn by the
    generator module `synthetic`."""
    return [(f"synthetic_dyn_{i:03d}", synthetic.make_dynamic_clip(t=t, h=h, w=w, seed=100 + i)[0]) if i % 3 == 2
            else (f"synthetic_{i:03d}", synthetic.make_shaky_clip(t=t, h=h, w=w, seed=100 + i)[0])
            for i in range(n)]


def _jax_generator():
    """The JAX package's `vstab/eval/synthetic.py`, loaded from its file: it
    imports numpy (and OpenCV inside its functions), nothing of JAX."""
    spec = importlib.util.spec_from_file_location("reference_synthetic",
                                                  os.path.join(REPO, "vstab", "eval", "synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clips(ref, synthetic):
    """Every quality clip by name: the gate clips, the eval set, the 720p clips."""
    out = {}
    for name, (fn, kw) in ref["settings"]["gate_clips"].items():
        out[name] = getattr(synthetic, fn)(**kw)[0]
    t, h, w = ref["settings"]["eval_shape"]
    out.update(_clip_set(synthetic, ref["N"], t, h, w))
    for s in ref["hd720"]["seeds"]:
        out[f"hd720_seed{s}"] = synthetic.make_shaky_clip(t=48, h=720, w=1280, seed=s)[0]
    return out


def write(d: str) -> None:
    import jax.numpy as jnp
    import torch_quality_reference as jref
    import vstab.eval.synthetic as jsyn
    from vstab.eval.metrics import evaluate_videos

    ref = json.load(open(jref.JSON_PATH))
    os.makedirs(d, exist_ok=True)
    digests = {"opencv": {k: _digest(v) for k, v in _clips(ref, jsyn).items()}}
    with jref.numpy_drawing():
        digests["numpy"] = {k: _digest(v) for k, v in _clips(ref, jsyn).items()}
    opencv_001 = _clip_set(jsyn, 2, *ref["settings"]["eval_shape"])[1][1]
    np.save(os.path.join(d, "synthetic_001_opencv.npy"), _u8(opencv_001))
    cfg = jref.config({}, "float32")
    clips = jref.eval_clips(max(PAIRS) + 1)
    pairs, scores = {}, {}
    for i in PAIRS:
        name, frames = clips[i]
        fr = jnp.asarray(frames)
        out = jref.stabilize_from_flow(fr, jref.clip_flow_of(fr, "float32"), cfg)
        pairs[f"{name}_in"], pairs[f"{name}_out"] = _u8(frames), _u8(out)
        scores[name] = evaluate_videos(pairs[f"{name}_in"], pairs[f"{name}_out"])
    np.savez_compressed(os.path.join(d, "pairs.npz"), **pairs)
    import cv2

    with open(os.path.join(d, "written.json"), "w") as f:
        json.dump({"cv2": cv2.__version__, "numpy": np.__version__, "digests": digests, "pair_scores": scores}, f)


def check(d: str) -> dict:
    import cv2

    from vstab_torch.eval import quality, synthetic
    from vstab_torch.eval.metrics import evaluate_videos

    ref = quality.load_reference(os.path.join(HERE, "torch_quality_reference.json"))
    want = json.load(open(os.path.join(d, "written.json")))
    jsyn = _jax_generator()
    got = {"opencv": {k: _digest(v) for k, v in _clips(ref, jsyn).items()},
           "numpy": {k: _digest(v) for k, v in _clips(ref, synthetic).items()}}
    here = _u8(_clip_set(jsyn, 2, *ref["settings"]["eval_shape"])[1][1]).astype(np.int16)
    there = np.load(os.path.join(d, "synthetic_001_opencv.npy")).astype(np.int16)
    step = np.abs(here - there)
    pairs = np.load(os.path.join(d, "pairs.npz"))
    score_diff = max(abs(evaluate_videos(pairs[f"{n}_in"], pairs[f"{n}_out"])[k] - v)
                     for n, s in want["pair_scores"].items() for k, v in s.items())
    clip = _clip_set(synthetic, 2, *ref["settings"]["eval_shape"])[1][1]
    flips = float((_u8(quality.noisy(clip, 0)) != _u8(clip)).mean())
    return {
        "here": {"cv2": cv2.__version__, "numpy": np.__version__},
        "written_with": {"cv2": want["cv2"], "numpy": want["numpy"]},
        "clips_drawn_differently": {p: sorted(k for k in want["digests"][p] if want["digests"][p][k] != got[p][k])
                                    for p in ("opencv", "numpy")},
        "clips": len(want["digests"]["opencv"]),
        "synthetic_001_by_opencv": {"share_of_uint8_values_moved": float((step > 0).mean()),
                                    "largest_step": int(step.max())},
        "shipped_pairs_largest_score_difference": score_diff,
        "one_noise_draw_flips_share_of_uint8_values": flips,
    }


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("--write", "--check"):
        sys.exit(f"usage: python {sys.argv[0]} --write DIR | --check DIR")
    if sys.argv[1] == "--write":
        write(sys.argv[2])
    else:
        print(json.dumps(check(sys.argv[2])))
