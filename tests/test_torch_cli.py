"""`python -m vstab_torch` end to end, as subprocesses on the CPU
(`--device cpu`) with a tiny network: the short in-memory path, the switch to
the blocked path for long inputs with its stats keys and log lines, a missing
input failing before the parameters load, and `--device cuda` refusing to run
without a card. The outputs are held to the port's library calls on the same
decoded frames within the codec's error (mean absolute difference 0.05)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_CFG = {
    "flow": {
        "pyramid_channels": [8, 12, 16],
        "estimator_channels": [16, 12],
        "kernel_impl": "xla",
        "compute_dtype": "float32",
        "output_level": 1,
    },
    "smooth": {"method": "sparse_ls", "grid_size": [4, 4]},
    "render": {"crop_mode": "fixed", "kernel_impl": "xla"},
    "dist": {"time_block_len": 8},
}


def _run_cli(args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "vstab_torch", *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=_REPO,
    )


@pytest.fixture(scope="module")
def cfg_json(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "cfg.json"
    p.write_text(json.dumps(TINY_CFG))
    return str(p)


@pytest.fixture(scope="module")
def src_video(tmp_path_factory):
    pytest.importorskip("cv2")
    from vstab_torch.eval.synthetic import make_shaky_clip
    from vstab_torch.io.video import write_video

    path = str(tmp_path_factory.mktemp("cli_vid") / "in.mp4")
    frames, _ = make_shaky_clip(t=40, h=48, w=64, seed=3)
    write_video(path, frames, fps=24.0)
    return path


def _library_params():
    from vstab_torch.core.config import Config
    from vstab_torch.pipeline import default_params

    cfg = Config.from_json(json.dumps(TINY_CFG))
    return cfg, default_params(cfg, ckpt_dir="/nonexistent", device="cpu")


def test_stabilize_short_path(tmp_path, cfg_json, src_video):
    """<= 4 * time_block_len frames: the whole-clip in-memory path."""
    import vstab_torch
    from vstab_torch.io.video import read_video

    dst = str(tmp_path / "out.mp4")
    r = _run_cli(["stabilize", src_video, dst, "--config", cfg_json, "--device", "cpu",
                  "--max-frames", "20", "--ckpt-dir", "/nonexistent"])
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(rec) == {"input", "output", "frames", "fps_processed"}
    assert rec["frames"] == 20 and rec["input"] == src_video and rec["output"] == dst
    out, _ = read_video(dst)
    assert out.shape == (20, 48, 64, 3) and np.isfinite(out).all()
    cfg, params = _library_params()
    want, _ = vstab_torch.stabilize(read_video(src_video, max_frames=20)[0], params, cfg, device="cpu")
    assert np.mean(np.abs(out - want.numpy())) < 0.05


def test_stabilize_auto_blocked_switch(tmp_path, cfg_json, src_video):
    """40 frames > 4 * time_block_len (8): the CLI switches to the blocked
    streaming path on its own."""
    from vstab_torch.io.video import read_video

    dst = str(tmp_path / "out.mp4")
    r = _run_cli(["stabilize", src_video, dst, "--config", cfg_json, "--device", "cpu",
                  "--ckpt-dir", "/nonexistent"])
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(rec) == {
        "frames", "block_len", "max_disp", "wall_s", "stage_s", "host_s", "pinned_bytes",
        "prefault_bytes", "fps_processed",
        "resume_cached_blocks", "input", "output", "fps",
    }
    assert rec["frames"] == 40 and rec["block_len"] == 8
    assert rec["stage_s"]["flow"] > 0 and rec["resume_cached_blocks"] == 0
    assert rec["prefault_bytes"] == 0  # the video writer owns no output array
    assert read_video(dst)[0].shape[0] == 40
    assert not os.path.exists(dst + ".resume")
    # blocked runs log per-block progress
    assert "motion block 1/5" in r.stderr and "render block 5/5" in r.stderr


def test_blocked_flags(tmp_path, cfg_json, src_video):
    """--blocked forces the streaming path on a short input; --block-len,
    --no-resume, --method and --crop reach it."""
    dst = str(tmp_path / "out.mp4")
    r = _run_cli(["stabilize", src_video, dst, "--config", cfg_json, "--device", "cpu",
                  "--ckpt-dir", "/nonexistent", "--max-frames", "11", "--blocked",
                  "--block-len", "4", "--no-resume", "--method", "affine", "--crop", "auto"])
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["frames"] == 11 and rec["block_len"] == 4
    assert "motion block 3/3" in r.stderr


def test_bad_input_fails_before_the_parameters_load(tmp_path, cfg_json):
    r = _run_cli(["stabilize", "/nonexistent.mp4", str(tmp_path / "o.mp4"), "--config", cfg_json,
                  "--device", "cpu", "--ckpt-dir", "/nonexistent"], timeout=120)
    assert r.returncode != 0
    assert "cannot open video" in r.stderr
    assert "fresh init" not in r.stderr and "checkpoint" not in r.stderr


def test_default_device_needs_a_card(tmp_path, cfg_json):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    for args in (["stabilize", "/nonexistent.mp4", str(tmp_path / "o.mp4"), "--config", cfg_json],
                 ["bench", "--frames", "3", "--height", "64", "--width", "64"]):
        r = _run_cli(args, timeout=120)
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr and "device='cpu'" in r.stderr
        assert r.stdout.strip() == ""


def test_eval_and_debug_are_not_offered(cfg_json):
    """Without a card, `eval` and `stabilize --debug` on the default device
    fail on the device: both are parsed (`--debug` runs in
    `tests/test_torch_debug.py`), neither falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    for args in (["eval"], ["stabilize", "a.mp4", "b.mp4", "--debug"]):
        r = _run_cli(args, timeout=120)
        assert r.returncode != 0 and "unrecognized arguments" not in r.stderr
        assert "no CUDA device" in r.stderr
