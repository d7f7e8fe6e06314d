"""vstab_torch at the long-clip and 4K sizes, held against the JAX package on
the CPU: the render warps at the 1080p and 4K widths with the 127 and 255
buckets, the displacement bound and its bucket at 2160x3840, the render at
d = 255 on a 3840-wide clip, the global path solve of a 1024-frame clip, and
the blocked pipeline on a 4K-wide strip.

Tolerances:
- 1-D warps, plain and wrapper against the XLA twins: 1e-5 abs, as in
  tests/test_torch_kernels.py;
- the displacement bound: 1e-5 relative, and the same bucket;
- the render: 1e-4, as in tests/test_torch_render.py, plus one f32 step
  of a column coordinate in [2048, 4096) (2^-12 px): the reference's render
  is jitted, and XLA fuses the crop zoom's source coordinate
  c + scale * (i - c) into one multiply-add, which rounds 1011 of the 3840
  columns one step apart from the same formula computed in two roundings
  (the port's, and the reference's own `zoom_resample` called eagerly); a
  tap weight moves by that step, the output by up to the step times the
  largest difference between neighbouring pixel values (1). Measured:
  2.6e-4 at most, 0.30% of the values past 1e-4 (crop 'fixed');
- the sparse-LS solve at T = 1024: no further from a float64 solve than
  twice the reference's distance (plus 1e-5), as tests/test_torch_smooth.py
  holds the solves, and within 2e-4 of the largest |profile| of the
  reference: tests/test_torch_smooth.py's 5e-3 px on paths of +-25 px. The
  f32 solves differ by about 1e-4 of the solution's size (the header of
  tests/test_torch_smooth.py), and a 1024-frame walk reaches 189 px: there
  the reference is 0.037 px from float64, the port 0.023 px, and the two
  0.015 px apart (measured); the affine solve: 1e-5 on the linear part and
  2e-3 px on translations, as `chain_path` is held in
  tests/test_torch_affine.py;
- the blocked strip against the reference's blocked run: 1e-3 on at least
  99.9% of the values, as in tests/test_torch_blocked.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import vstab.core.config as jcfg
from vstab.core.config import RenderConfig as RenderRef
from vstab.flow.pwcnet import init_params
from vstab.kernels.warp1d import hwarp_xla, vwarp_xla
from vstab.pipeline_blocked import _solve_path as solve_path_ref
from vstab.pipeline_blocked import stabilize_blocked as stabilize_blocked_ref
from vstab.render import render as ref
from vstab.smooth import sparse_ls as sparse_ls_ref
import vstab_torch
from vstab_torch.core import config as tcfg
from vstab_torch.core.config import RenderConfig
from vstab_torch.eval.synthetic import make_shaky_clip
from vstab_torch.kernels import hwarp, hwarp_plain, vwarp, vwarp_plain
from vstab_torch.render import render as port
from vstab_torch.smooth.stages import solve_path
from vstab_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)
ATOL = 1e-5


def _contract_field(d, h, w):
    """The reference's field for the wide buckets: a rotation-and-zoom-like
    ramp over most of [-d, d] with a gentle wave down the rows."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return (0.9 * d * (2.0 * xx / w - 1.0) + 0.05 * d * np.sin(yy / 17.0))[None].astype(np.float32)


@pytest.mark.parametrize("mode", ["edge", "wrap"])
@pytest.mark.parametrize("d,w", [(127, 1920), (255, 1920), (255, 3840)])
def test_1d_warps_match_xla_at_the_contract_widths(d, w, mode):
    h = 96
    img = np.random.default_rng(30).random((1, h, w, 3)).astype(np.float32)
    f = _contract_field(d, h, w)
    for plain, wrapper, xla in ((vwarp_plain, vwarp, vwarp_xla), (hwarp_plain, hwarp, hwarp_xla)):
        want = np.asarray(xla(jnp.asarray(img), jnp.asarray(f), max_disp=d, mode=mode))
        for fn in (plain, wrapper):
            got = fn(torch.from_numpy(img), torch.from_numpy(f), d, mode)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _wide_affines(rng, t):
    """Per-frame warps whose rotation and zoom move a 3840x2160 frame's
    corners by 130 to 250 px from its centre's motion."""
    a = np.zeros((t, 2, 3), np.float32)
    rot = rng.uniform(0.055, 0.075, size=t) * rng.choice([-1.0, 1.0], size=t)
    zoom = rng.uniform(0.01, 0.03, size=t)
    a[:, 0, 0] = a[:, 1, 1] = 1.0 + zoom
    a[:, 0, 1], a[:, 1, 0] = -rot, rot
    a[:, :, 2] = rng.normal(scale=20.0, size=(t, 2))
    return a


@pytest.mark.parametrize("method", ["affine", "sparse_ls"])
def test_residual_disp_bound_takes_the_255_bucket_at_4k(method):
    rng = np.random.default_rng(12)
    if method == "affine":
        path = _wide_affines(rng, 7)
    else:
        path = rng.normal(scale=45.0, size=(7, 12, 16, 2)).astype(np.float32)
    b_ref = float(ref.residual_disp_bound(path, 2160, 3840, method))
    b_port = float(port.residual_disp_bound(path, 2160, 3840, method))
    assert 127.0 < b_ref < 254.0  # past the 127 bucket, inside the 255 one
    assert abs(b_port - b_ref) <= 1e-5 * b_ref
    assert port.pick_max_disp(b_port, RenderConfig()) == ref.pick_max_disp(b_ref, RenderRef()) == 255


@pytest.mark.parametrize("crop_mode", ["fixed", "auto", "none"])
def test_render_stabilized_at_d255_matches_reference(crop_mode):
    """A 2x64x3840 clip whose grid path moves columns by up to ~200 px from
    the frame's mean and rows by up to ~20, rendered at the 255 bucket."""
    rng = np.random.default_rng(13)
    t, h, w = 2, 64, 3840
    frames = rng.random((t, h, w, 3)).astype(np.float32)
    path = np.zeros((t, 4, 6, 2), np.float32)
    path[..., 0] = rng.uniform(-200.0, 200.0, size=(t, 4, 6))
    path[..., 1] = rng.uniform(-20.0, 20.0, size=(t, 4, 6))
    assert 127.0 < float(port.residual_disp_bound(path, h, w, "sparse_ls")) < 254.0
    flow_r = ref.grid_to_flow(jnp.asarray(path), h, w)
    flow_p = port.grid_to_flow(torch.from_numpy(path), h, w)
    want = ref.render_stabilized(
        jnp.asarray(frames), flow_r, RenderRef(crop_mode=crop_mode, kernel_impl="xla"), max_disp=255,
    )
    got = port.render_stabilized(
        torch.from_numpy(frames), flow_p, RenderConfig(crop_mode=crop_mode), max_disp=255
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4 + 2.0**-12)


def _smoothed64(c, cfg):
    """float64 smoothed profiles of c [T,GH,GW,2]: the normal equations of
    `smooth_profiles`, one symmetric pentadiagonal solve a spatial mode."""
    t, gh, gw, _ = c.shape
    v, mu = (x.astype(np.float64) for x in sparse_ls_ref.spatial_modes(gh, gw))
    td0, td1, td2 = (x.astype(np.float64) for x in sparse_ls_ref.temporal_diagonals(
        t, cfg.lambda_smooth, cfg.lambda_accel))
    alpha = cfg.lambda_data + cfg.lambda_rigid * mu
    ctil = np.einsum("ig,tic->tgc", v, c.reshape(t, -1, 2).astype(np.float64))  # [T, modes, 2]
    ptil = np.empty_like(ctil)
    for g, a in enumerate(alpha):
        bands = np.zeros((3, t))  # upper form: bands[2 - k, k:] is diagonal k
        bands[0, 2:], bands[1, 1:], bands[2] = td2, td1, td0 + a + cfg.damping
        ptil[:, g] = scipy.linalg.solveh_banded(bands, a * ctil[:, g])
    return np.einsum("ig,tgc->tic", v, ptil).reshape(c.shape)


def _random_walk_motion(rng, t, method):
    """Per-pair motion of a 1024-frame handheld clip: vertex motion with a
    shared shake and some independent jitter (sparse-LS), or pair affines
    with small rotations and zooms (affine)."""
    if method == "affine":
        a = np.zeros((t - 1, 2, 3), np.float32)
        a[:, :, :2] = np.eye(2) + rng.normal(scale=1e-3, size=(t - 1, 2, 2))
        a[:, :, 2] = rng.normal(scale=2.0, size=(t - 1, 2))
        return a
    shake = rng.normal(scale=3.0, size=(t - 1, 1, 1, 2))
    return (shake + rng.normal(scale=0.5, size=(t - 1, 12, 16, 2))).astype(np.float32)


@pytest.mark.parametrize("method", ["sparse_ls", "affine"])
def test_solve_path_of_a_1024_frame_clip_matches_reference(method):
    t = 1024
    motion = _random_walk_motion(np.random.default_rng(14), t, method)
    cfg_r = jcfg.Config(smooth=jcfg.SmoothConfig(method=method))
    cfg_p = tcfg.Config(smooth=tcfg.SmoothConfig(method=method))
    want = solve_path_ref(motion, cfg_r)
    got = solve_path(torch.from_numpy(motion), cfg_p.smooth)[0].numpy()
    assert got.shape == want.shape == ((t, 2, 3) if method == "affine" else (t, 12, 16, 2))
    if method == "affine":
        np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=2e-3)
        return
    assert t >= 3 * cfg_p.smooth.block_len  # the Schur branch of the solve
    c = np.concatenate([np.zeros_like(motion[:1]), np.cumsum(motion, axis=0, dtype=np.float64)])
    exact = c - _smoothed64(c, cfg_p.smooth)
    got64, want64 = got.astype(np.float64), want.astype(np.float64)
    assert np.abs(got64 - want64).max() <= 5e-3 / 25.0 * np.abs(c).max()
    assert np.abs(got64 - exact).max() <= 2 * np.abs(want64 - exact).max() + 1e-5


def _tiny(mod):
    """The narrow network of tests/test_torch_blocked.py, estimating at the
    default level (1/4): a quarter of the context network's work at 1/2."""
    return mod.Config(
        flow=mod.FlowConfig(
            pyramid_channels=(8, 12, 16), estimator_channels=(16, 12),
            kernel_impl="xla", compute_dtype="float32", output_level=2,
        ),
        render=mod.RenderConfig(crop_mode="fixed", kernel_impl="xla"),
    )


def test_blocked_4k_wide_strip_matches_reference():
    """Five frames of 64x3840 in blocks of 2 (three motion and three render
    blocks, the last padded): every kernel's plain version at 3840 columns."""
    frames, _ = make_shaky_clip(t=5, h=64, w=3840, seed=9, shake_px=10.0)
    jp = init_params(jax.random.PRNGKey(0), _tiny(jcfg).flow)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    want = np.asarray(stabilize_blocked_ref(frames, jp, _tiny(jcfg), block_len=2))
    got = vstab_torch.stabilize_blocked(frames, tp, _tiny(tcfg), block_len=2, device="cpu")
    assert got.shape == frames.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= 1e-3).mean() >= 0.999, (err.max(), (err > 1e-3).mean())
