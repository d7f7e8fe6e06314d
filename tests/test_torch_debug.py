"""vstab_torch's checked stabilization (`utils/debug.py`) on the CPU, the
counterpart of `tests/utils/test_debug.py`.

The reference runs its stages under checkify, whose full-pipeline tests
need minutes of compile; the port's checks are explicit tensors between
eager stages, so the whole pipeline runs here unmarked. Clean input gives
`stabilize`'s output to the bit (the same operations in the same order);
a NaN raises with "nan" in the message and the stage named.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vstab_torch.core.config import Config, FlowConfig, RenderConfig, SmoothConfig, preset
from vstab_torch.eval.synthetic import make_shaky_clip
from vstab_torch.pipeline import default_params, stabilize
from vstab_torch.utils.debug import _smooth_and_render_checked, stabilize_checked

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clip():
    cfg = preset("affine_480p")
    frames, _ = make_shaky_clip(t=6, h=48, w=64, seed=3)
    flow = 0.5 * torch.ones((frames.shape[0] - 1,) + frames.shape[1:3] + (2,))  # consecutive-pair flow
    return torch.from_numpy(frames), flow, cfg


@pytest.fixture(scope="module")
def params(clip):
    return default_params(clip[2], ckpt_dir="/nonexistent", device="cpu")


def test_smooth_render_clean(clip):
    frames, flow, cfg = clip
    out, _ = _smooth_and_render_checked(frames, flow, cfg)
    assert out.shape == frames.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_smooth_render_nonfinite_flow_raises(clip, bad):
    frames, flow, cfg = clip
    poisoned = flow.clone()
    poisoned[2] = bad  # a whole pair's flow field
    with pytest.raises(FloatingPointError) as ei:
        _smooth_and_render_checked(frames, poisoned, cfg)
    kind = "nan" if bad != bad else "inf"
    assert f"{64 * 48 * 2} {kind} values in the flow" in str(ei.value)


def test_render_displacement_beyond_its_bucket_raises(clip):
    """A roll of +-0.3 rad a pair leaves residual displacements of about
    8 px on a 48x64 frame. With a static bound of 4 px (adaptive_max_disp
    off) the 1-D warps would clamp those taps: raised. The adaptive bucket
    of the same path (16) covers it, and runs clean."""
    frames, _, cfg = clip
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    flow = np.stack([np.stack([-a * (yy - 24), a * (xx - 32)], -1) for a in (0.3, -0.3, 0.3, -0.3, 0.3)])
    flow = torch.from_numpy(flow.astype(np.float32))
    static = cfg.replace(render=RenderConfig(adaptive_max_disp=False, max_residual_disp=4))
    with pytest.raises(IndexError, match=r"residual displacement up to .* leaves the render's bucket \+-4 px"):
        _smooth_and_render_checked(frames, flow, static)
    out, _ = _smooth_and_render_checked(frames, flow, cfg)
    assert bool(torch.isfinite(out).all())


def test_full_pipeline_clean_equals_stabilize(clip, params):
    frames, _, cfg = clip
    got, diags = stabilize_checked(frames[:4], params, cfg, device="cpu")
    want, want_diags = stabilize(frames[:4], params, cfg, device="cpu")
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    assert set(diags) == set(want_diags) and all(torch.equal(diags[k], want_diags[k]) for k in diags)


def test_full_pipeline_sparse_ls_equals_stabilize():
    """The default smoothing on a tiny network: the grid path's bucket."""
    cfg = Config(
        flow=FlowConfig(pyramid_channels=(8, 12, 16), estimator_channels=(16, 12), compute_dtype="float32",
                        output_level=1),
        smooth=SmoothConfig(grid_size=(4, 4)),
    )
    params = default_params(cfg, seed=0, ckpt_dir="/nonexistent", device="cpu")
    frames, _ = make_shaky_clip(t=9, h=48, w=64, seed=1)
    got, _ = stabilize_checked(frames, params, cfg, device="cpu")
    assert torch.equal(got, stabilize(frames, params, cfg, device="cpu")[0])


def test_full_pipeline_nan_input_raises(clip, params):
    frames, _, cfg = clip
    bad = frames[:4].clone()
    bad[2, 10, 10, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="1 nan values in the input frames"):
        stabilize_checked(bad, params, cfg, device="cpu")


def test_default_device_needs_a_card(clip, params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stabilize_checked(clip[0][:4], params, clip[2])


def test_cli_stabilize_debug(tmp_path):
    """`python -m vstab_torch stabilize --debug` on a short synthetic file."""
    pytest.importorskip("cv2")
    from vstab_torch.io.video import read_video, write_video

    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    write_video(src, make_shaky_clip(t=12, h=48, w=64, seed=3)[0], fps=24.0)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "flow": {"pyramid_channels": [8, 12, 16], "estimator_channels": [16, 12], "compute_dtype": "float32",
                 "output_level": 1},
        "smooth": {"grid_size": [4, 4]},
    }))
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "vstab_torch", "stabilize", src, dst, "--debug", "--device", "cpu",
         "--config", str(cfg), "--ckpt-dir", "/nonexistent"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["frames"] == 12
    assert read_video(dst)[0].shape == (12, 48, 64, 3)
