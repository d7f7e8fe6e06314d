"""vstab_torch's eval harness held against the JAX package on the CPU.

Tolerances: the three scores 1e-5 abs against the JAX functions (f32, another
FFT and summation order); scenes and clips 1e-6 (numpy on both sides, with the
reference's OpenCV paths switched off, since the port's copy is numpy only).
The sweeps run the port's pipeline on the CPU with a tiny random network.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstab.eval.deepstab as jdeep
import vstab.eval.metrics as jmetrics
import vstab.eval.synthetic as jsyn
from vstab_torch.cli import main as cli_main
from vstab_torch.core import config as tcfg
from vstab_torch.eval import deepstab, metrics, synthetic

torch.set_num_threads(1)

TINY_CFG = {
    "flow": {
        "pyramid_channels": [8, 12, 16], "estimator_channels": [16, 12],
        "kernel_impl": "xla", "compute_dtype": "float32", "output_level": 1,
    },
    "smooth": {"method": "sparse_ls", "grid_size": [4, 4]},
    "render": {"crop_mode": "fixed", "kernel_impl": "xla"},
}


def _transforms(rng, t, shake=1.0, aniso=0.0):
    """[t,2,3] affines near the identity: rotation, scale, anisotropy, shift."""
    ang = rng.normal(0, 0.02 * shake, t)
    s = 1.0 + rng.normal(0, 0.03 * shake, t)
    a = np.zeros((t, 2, 3), np.float32)
    a[:, 0, 0], a[:, 0, 1] = s * np.cos(ang), -s * np.sin(ang) * (1 + aniso)
    a[:, 1, 0], a[:, 1, 1] = s * np.sin(ang), s * np.cos(ang) * (1 - aniso)
    a[:, :, 2] = rng.normal(0, 4.0 * shake, (t, 2))
    return a


def _identity(t):
    a = np.zeros((t, 2, 3), np.float32)
    a[:, 0, 0] = a[:, 1, 1] = 1.0
    return a


_CASES = {
    "long": lambda: _transforms(np.random.default_rng(0), 47, aniso=0.1),
    "aniso": lambda: _transforms(np.random.default_rng(1), 30, aniso=0.3),
    "short_4": lambda: _transforms(np.random.default_rng(2), 4, aniso=0.2),  # 3 rfft bins: spec[1:6] is cut
    "short_2": lambda: _transforms(np.random.default_rng(3), 2, aniso=0.2),
    "one": lambda: _transforms(np.random.default_rng(4), 1, aniso=0.2),
    "motionless": lambda: _identity(20),  # no AC energy: stability 1
    "only_x_moves": lambda: np.concatenate(  # two motionless components, one moving
        [_identity(16)[:, :, :2], np.stack([np.random.default_rng(5).normal(0, 3, 16), np.zeros(16)], -1)[:, :, None]
         .astype(np.float32)], axis=2),
}


@pytest.mark.parametrize("fn", ["stability_score", "cropping_ratio", "distortion_score"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_scores_match_jax(case, fn):
    a = _CASES[case]()
    want = float(getattr(jmetrics, fn)(jnp.asarray(a)))
    got = getattr(metrics, fn)(torch.from_numpy(a))
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5, (float(got), want)


def test_distortion_of_exact_similarities_is_one_to_the_root_of_f32_rounding():
    """For a similarity the two singular values coincide and the score's
    discriminant tr^2/4 - det is a difference of equal numbers: what is left
    of it is rounding, and its square root (about 3e-4) is what either
    package returns below 1. Away from that point (every `aniso` case above)
    the two agree to 1e-5."""
    a = _transforms(np.random.default_rng(6), 40)
    want = float(jmetrics.distortion_score(jnp.asarray(a)))
    got = float(metrics.distortion_score(torch.from_numpy(a)))
    assert 1.0 - 2e-3 <= got <= 1.0 and 1.0 - 2e-3 <= want <= 1.0


def test_motionless_path_is_perfectly_stable():
    assert float(metrics.stability_score(torch.from_numpy(_identity(12)))) == 1.0
    assert float(metrics.cropping_ratio(torch.from_numpy(_identity(12)))) == pytest.approx(1.0, abs=1e-6)
    assert float(metrics.distortion_score(torch.from_numpy(_identity(12)))) == pytest.approx(1.0, abs=1e-6)


@pytest.fixture
def no_cv2(monkeypatch):
    """The reference's numpy paths: what the port's copy always takes."""
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.mark.parametrize("kind", ["checker", "perlin", "shapes"])
@pytest.mark.parametrize("hw,seed", [((48, 64), 0), ((96, 72), 7)])
def test_scenes_match_reference(no_cv2, kind, hw, seed):
    want = jsyn.make_scene(kind, *hw, seed=seed)
    got = synthetic.make_scene(kind, *hw, seed=seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_unknown_scene_kind_raises():
    with pytest.raises(ValueError, match="unknown scene kind"):
        synthetic.make_scene("marble", 8, 8)
    with pytest.raises(ValueError, match="unknown scene kind"):
        synthetic.make_shaky_clip(t=2, h=8, w=8, scene_kind="marble")


@pytest.mark.parametrize("kw", [dict(t=5, h=40, w=56, seed=2), dict(t=4, h=48, w=48, seed=9, n_occluders=2, scene_kind="perlin")])
def test_dynamic_clip_matches_reference(no_cv2, kw):
    want, cams_w = jsyn.make_dynamic_clip(**kw)
    got, cams = synthetic.make_dynamic_clip(**kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(cams, cams_w)
    planar, _ = synthetic.make_shaky_clip(**{k: v for k, v in kw.items() if k != "n_occluders"})
    assert np.abs(got - planar).max() > 0.05  # the occluders are there


def test_synthetic_clip_set_matches_reference(no_cv2):
    want = jdeep.synthetic_clip_set(3, t=3, h=32, w=40)
    got = deepstab.synthetic_clip_set(3, t=3, h=32, w=40)
    assert [n for n, _ in got] == [n for n, _ in want] == ["synthetic_000", "synthetic_001", "synthetic_dyn_002"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_enumerate_clips_prefers_the_unstable_directory(tmp_path):
    for name in ("b.mp4", "a.AVI", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert deepstab.enumerate_clips(str(tmp_path)) == jdeep.enumerate_clips(str(tmp_path))
    assert [os.path.basename(p) for p in deepstab.enumerate_clips(str(tmp_path))] == ["a.AVI", "b.mp4"]
    (tmp_path / "unstable").mkdir()
    (tmp_path / "unstable" / "c.mkv").write_bytes(b"")
    assert [os.path.basename(p) for p in deepstab.enumerate_clips(str(tmp_path))] == ["c.mkv"]
    assert deepstab.enumerate_clips(str(tmp_path / "missing")) == []


_REC = {"clip": "synthetic_000", "stability": 0.5, "cropping": 0.9, "distortion": 0.95, "frames": 9,
        "fps": 3.0, "wall_s": 3.0}


def test_append_record_heals_a_torn_tail(tmp_path):
    path = str(tmp_path / "results.jsonl")
    deepstab._append_record(path, _REC)
    with open(path, "a") as f:
        f.write('{"clip": "synthetic_001", "stabi')  # a write cut short, no newline
    deepstab._append_record(path, {**_REC, "clip": "synthetic_002"})
    done = deepstab._load_done(path)
    assert sorted(done) == ["synthetic_000", "synthetic_002"]
    assert done == jdeep._load_done(path)
    with open(path) as f:
        assert len(f.read().splitlines()) == 3


def test_load_done_skips_records_without_metrics(tmp_path):
    path = str(tmp_path / "results.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"clip": "a"}) + "\n\n" + json.dumps({"stability": 1.0}) + "\n[1, 2]\n")
        f.write(json.dumps({**_REC, "clip": "b"}) + "\n")
    assert sorted(deepstab._load_done(path)) == ["b"]
    assert deepstab._load_done(str(tmp_path / "missing.jsonl")) == {}


def test_aggregate_and_report_table_match_reference():
    recs = [{**_REC, "clip": f"c{i}", "stability": 0.4 + 0.1 * i, "fps": 2.0 + i} for i in range(3)]
    assert deepstab.aggregate(recs) == jdeep.aggregate(recs)
    assert deepstab.report_table(recs) == jdeep.report_table(recs)
    assert deepstab.aggregate([]) == {} and deepstab.report_table([]) == jdeep.report_table([])


def _tiny():
    from vstab_torch.pipeline import default_params

    cfg = tcfg.Config.from_json(json.dumps(TINY_CFG))
    return cfg, default_params(cfg, seed=0, ckpt_dir="/nonexistent", device="cpu")


_KEYS = {"clip", "stability", "cropping", "distortion", "frames", "fps", "wall_s"}


def test_sweep_writes_records_and_resume_skips_done_clips(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    cfg, params = _tiny()
    path = str(tmp_path / "out" / "results.jsonl")
    kw = dict(cfg=cfg, params=params, n_synthetic=2, synth_shape=(9, 64, 96), device="cpu")
    recs = deepstab.run_sweep(None, path, **kw)
    assert [r["clip"] for r in recs] == ["synthetic_000", "synthetic_001"]
    for r in recs:
        assert set(r) == _KEYS and r["frames"] == 9
        assert all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0 for k in ("stability", "cropping", "distortion"))
    with open(path) as f:
        assert [json.loads(l) for l in f] == recs

    calls = []
    real = deepstab.evaluate_clip
    monkeypatch.setattr(deepstab, "evaluate_clip", lambda *a, **k: calls.append(1) or real(*a, **k))
    assert deepstab.run_sweep(None, path, **kw) == recs and calls == []  # nothing is stabilized again
    more = deepstab.run_sweep(None, path, **{**kw, "n_synthetic": 3})  # one new clip, the dynamic one
    assert len(calls) == 1 and [r["clip"] for r in more] == ["synthetic_000", "synthetic_001", "synthetic_dyn_002"]


def test_batched_sweep_keeps_the_per_clip_accounting(tmp_path):
    pytest.importorskip("cv2")
    cfg, params = _tiny()
    path = str(tmp_path / "results.jsonl")
    recs = deepstab.run_sweep(None, path, cfg=cfg, params=params, n_synthetic=2, synth_shape=(9, 64, 96),
                              data_parallel=True, save_videos_dir=str(tmp_path / "vid"), device="cpu")
    assert len(recs) == 2
    for r in recs:
        assert set(r) == _KEYS | {"batch", "batch_wall_s"}
        assert r["batch"] == 1 and r["wall_s"] == r["batch_wall_s"]  # one device: a batch is one clip
    serial = deepstab.run_sweep(None, str(tmp_path / "serial.jsonl"), cfg=cfg, params=params, n_synthetic=2,
                                synth_shape=(9, 64, 96), device="cpu")
    for a, b in zip(recs, serial):  # stabilize_batch of one clip is stabilize
        assert all(a[k] == pytest.approx(b[k], abs=1e-6) for k in ("stability", "cropping", "distortion"))
    assert sorted(os.listdir(tmp_path / "vid")) == ["synthetic_000.stab.mp4", "synthetic_001.stab.mp4"]


def test_a_manifest_written_by_the_jax_harness_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX harness (tiny network, JAX on the CPU) writes the first clip's
    record; the port, given that file, stabilizes only the second."""
    pytest.importorskip("cv2")
    import vstab.core.config as jcfg

    jcfg_tiny = jcfg.Config(
        flow=jcfg.FlowConfig(pyramid_channels=(8, 16), estimator_channels=(16, 12), context_dilations=(1, 2, 1),
                             search_radius=2, kernel_impl="xla", compute_dtype="float32", output_level=1),
        smooth=jcfg.SmoothConfig(method="affine"),
    )
    path = str(tmp_path / "results.jsonl")
    first = jdeep.run_sweep(None, path, cfg=jcfg_tiny, n_synthetic=1, synth_shape=(8, 32, 48))
    assert len(first) == 1 and set(first[0]) == _KEYS

    cfg, params = _tiny()
    calls = []
    real = deepstab.evaluate_clip
    monkeypatch.setattr(deepstab, "evaluate_clip", lambda *a, **k: calls.append(1) or real(*a, **k))
    recs = deepstab.run_sweep(None, path, cfg=cfg, params=params, n_synthetic=2, synth_shape=(8, 32, 48), device="cpu")
    assert len(calls) == 1 and recs[0] == first[0] and recs[1]["clip"] == "synthetic_001"
    assert set(recs[1]) == set(first[0])
    # and the other way round: the JAX harness finds both clips done
    assert [r["clip"] for r in jdeep.run_sweep(None, path, cfg=jcfg_tiny, n_synthetic=2, synth_shape=(8, 32, 48))] == [
        "synthetic_000", "synthetic_001"]
    assert deepstab._load_done(path) == jdeep._load_done(path)


def test_eval_subcommand(tmp_path, capsys):
    pytest.importorskip("cv2")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(TINY_CFG))
    path = str(tmp_path / "results.jsonl")
    argv = ["eval", "--device", "cpu", "--config", str(cfg_path), "--results", path,
            "--n-synthetic", "2", "--synth-shape", "9", "64", "96"]
    assert cli_main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "| Clip | Stability | Cropping | Distortion | frames/s |"
    assert out[2].startswith("| synthetic_000 |") and out[3].startswith("| synthetic_001 |")
    agg = json.loads(out[-1])["aggregate"]
    assert set(agg) == {"stability", "cropping", "distortion", "fps"}
    assert len(deepstab._load_done(path)) == 2
    assert cli_main(argv + ["--max-frames", "5"]) == 0  # resumes: the same table
    assert capsys.readouterr().out.strip().splitlines()[:4] == out[:4]


def test_eval_subcommand_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["eval", "--results", str(tmp_path / "r.jsonl"), "--n-synthetic", "1"])


def test_scores_of_the_trained_network_match_the_jax_pipeline_in_f32(capsys):
    """`flow_086000` at full width with f32 flow on synthetic_000 at 24x128x160,
    through both packages' `stabilize` on the CPU: the two videos agree (99.5%
    of the values within 2e-3; the rest sit where the validity threshold
    flips), the port's `evaluate_videos` returns the JAX package's scores on
    the same video to 1e-5, and cropping and distortion of the two videos
    agree to 5e-3. The distortion lies under 0.9 in both: what the tracked
    full-affine fit reads off the vertex grid's local warps on this clip, not
    something the port adds. The stability score is printed and not held: it
    moves by hundredths between two videos this close (RANSAC over KLT tracks,
    the spectrum of 23 transforms)."""
    pytest.importorskip("cv2")
    import dataclasses

    import vstab
    import vstab.pipeline as jpipe
    import vstab_torch

    (name, frames), = deepstab.synthetic_clip_set(1, t=24, h=128, w=160)
    base = vstab_torch.Config()
    cfg = dataclasses.replace(base, flow=dataclasses.replace(base.flow, compute_dtype="float32"))
    jbase = vstab.Config()
    jcfg = dataclasses.replace(
        jbase, flow=dataclasses.replace(jbase.flow, compute_dtype="float32", kernel_impl="xla"),
        render=dataclasses.replace(jbase.render, kernel_impl="xla"))
    got, _ = vstab_torch.stabilize(frames, vstab_torch.default_params(cfg, device="cpu"), cfg, device="cpu")
    want, _ = jpipe.stabilize(jnp.asarray(frames), jpipe.default_params(jcfg), jcfg)
    got, want = got.numpy(), np.asarray(want)
    assert (np.abs(got - want) <= 2e-3).mean() >= 0.995

    mine = metrics.evaluate_videos(frames, got)
    same = jmetrics.evaluate_videos(frames, got)
    assert all(abs(mine[k] - same[k]) <= 1e-5 for k in same) and set(mine) == set(same)
    ref = metrics.evaluate_videos(frames, want)
    with capsys.disabled():
        print(f"\n{name} 24x128x160 f32, port / JAX video: " + json.dumps({k: [mine[k], ref[k]] for k in mine}))
    assert abs(mine["cropping"] - ref["cropping"]) <= 5e-3
    assert abs(mine["distortion"] - ref["distortion"]) <= 5e-3
    assert 0.8 < mine["distortion"] < 0.9 and 0.8 < ref["distortion"] < 0.9
