"""`tests/torch_quality_reference.json`, the JAX package's quality readings
that the port is held to: where it comes from and what it fixes.

Two of its entries are recomputed live through the JAX package's own
`stabilize` on the CPU and must match to 1e-6 (one clip of the eval set in
f32, draw 0 of the dynamic gate clip); its sigma, N and tolerances follow
from its spread by the rule it states; the port draws the same input noise
and the same clips (the generator's numpy paths, the file's clip sums).
"""

import math

import numpy as np
import pytest

import torch_quality_reference as jref
from vstab_torch.eval import quality
from vstab_torch.eval.deepstab import synthetic_clip_set

REF = quality.load_reference(jref.JSON_PATH)


def _close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    assert all(abs(got[k] - want[k]) <= 1e-6 for k in want), (got, want)


def test_a_clip_of_the_eval_set_recomputes_live():
    (name, frames), = jref.eval_clips(1)
    assert name == REF["eval_set"]["clips"][0]
    _close(jref.stabilize_scores(frames, jref.config({}, "float32")), REF["eval_set"]["float32"][0])


def test_draw_0_of_the_dynamic_gate_clip_recomputes_live():
    run = REF["settings"]["gate_runs"]["dynamic_robust2"]
    frames, _ = jref.gate_clip(run["clip"])
    got = jref.stabilize_scores(jref.noisy(frames, 0), jref.config(run["config"], "float32"))
    _close(got, REF["gates"]["float32"]["runs"]["dynamic_robust2"]["draws"][0])


def test_sigma_n_and_tolerances_follow_from_the_spread():
    spread = REF["spread"]
    for dtype in jref.DTYPES:
        for s in jref.SCORES:
            stds = [np.std([d[s] for d in spread[c][dtype]["draws"]], ddof=1) for c in spread]
            assert REF["sigma"][dtype][s] == pytest.approx(math.sqrt(np.mean(np.square(stds))), abs=1e-12)
            for n, tol in REF["tolerance"][dtype].items():
                want = 3 * math.sqrt(2) * REF["sigma"][dtype][s] / math.sqrt(int(n))
                assert tol[s] == pytest.approx(max(want, 5e-3) if s == "cropping" else want, abs=1e-12)
    assert REF["N"] == jref.choose_n(REF["sigma"]["float32"]["stability"])
    assert REF["tolerance"]["float32"][str(REF["N"])]["stability"] <= jref.STAB_TOL_TARGET
    assert len(REF["eval_set"]["float32"]) == len(REF["eval_set"]["bfloat16"]) == REF["N"]
    k = REF["settings"]["K"]
    assert all(len(r["draws"]) == k for r in REF["gates"]["float32"]["runs"].values())


def test_the_port_draws_the_same_noise():
    frames = np.random.default_rng(5).random((3, 16, 24, 3), dtype=np.float32)
    frames[0, 0, 0] = [0.0, 1.0, 0.5]  # the clip to [0, 1] at both ends
    for k in (0, 7):
        np.testing.assert_array_equal(quality.noisy(frames, k), jref.noisy(frames, k))
    assert not np.array_equal(quality.noisy(frames, 0), frames)
    assert np.abs(quality.noisy(frames, 1) - frames).max() <= 1e-4 + 1e-7


@pytest.mark.parametrize("name", sorted(REF["settings"]["gate_clips"]))
def test_the_port_draws_the_reference_gate_clips(name):
    frames, cams = quality.gate_clip(REF, name)
    want, want_cams = jref.gate_clip(name)
    np.testing.assert_array_equal(frames, want)
    np.testing.assert_array_equal(cams, want_cams)
    quality.check_clips([frames], [REF["settings"]["gate_clip_sums"][name]],
                        [REF["settings"]["gate_clip_samples"][name]], name)


def test_the_port_draws_the_reference_eval_clips():
    n = 4  # every kind of clip: planar and with occluders
    got, want = quality.eval_clips(REF, n), jref.eval_clips(n)
    assert [a for a, _ in got] == [b for b, _ in want] == REF["eval_set"]["clips"][:n]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    kept = REF["eval_set"]["clip_sums"][:n], REF["eval_set"]["clip_samples"][:n]
    quality.check_clips([f for _, f in got], *kept, "eval set")
    pytest.importorskip("cv2")
    from vstab.eval.deepstab import synthetic_clip_set as jax_clip_set

    with pytest.raises(ValueError, match="not the reference's"):  # OpenCV's drawing: other frames and occluders
        quality.check_clips([jax_clip_set(3, *REF["settings"]["eval_shape"])[2][1]], kept[0][2:3],
                            kept[1][2:3], "eval set")


def test_eval_clips_are_the_clip_set_drawn_by_numpy():
    ref = {"N": 5, "settings": {"eval_shape": [4, 32, 40]}}
    want = synthetic_clip_set(5, 4, 32, 40)
    got = quality.eval_clips(ref)
    assert [a for a, _ in got] == [b for b, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
