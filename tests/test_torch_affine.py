"""vstab_torch's affine helpers and affine smoothing path held against the
JAX package on the CPU, inputs from a numpy seed.

Tolerances (f32 against f32, another summation order):
- the four affine helpers: 1e-6 relative, 1e-5 absolute on coordinates of
  a few hundred pixels;
- `fit_affine_from_flow`: the 3x3 normal equations hold sums up to
  P x 1280^2, so two f32 LU routines need not agree to 1e-6. The port is held
  to a float64 run of the same IRLS: no further from it than twice the
  reference is (with a floor of 4e-6 on the linear part and 2e-4 px on the
  translation), and within 1e-5 (linear part) and 5e-3 px (translation) of
  the reference itself (measured at 720p: both 1.5e-6 and 1.2e-3 to 1.5e-3
  px from float64, 3e-6 and 2.3e-3 px from each other);
- `chain_path` at T=300: 1e-5 on the linear part, 2e-3 px on translations
  that reach hundreds of pixels (the doubling scan and the reference's tree
  round in another order);
- `smooth_path`: 5e-6 on linear parts of up to 5 (a 55-tap sum), 1e-4 px on
  the translation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstab.core import types as ref_types
from vstab.smooth import affine as ref
from vstab_torch.core import types as port_types
from vstab_torch.smooth import affine as port

torch.set_num_threads(1)


def _affines(rng, *lead):
    a = np.zeros(lead + (2, 3), np.float32)
    a[..., :2] = np.eye(2) + rng.normal(scale=0.05, size=lead + (2, 2))
    a[..., 2] = rng.normal(scale=30.0, size=lead + (2,))
    return a.astype(np.float32)


@pytest.mark.parametrize("lead_a,lead_b", [((), ()), ((7,), (7,)), ((1, 5), (4, 1)), ((), (3,))])
def test_compose_affine_matches_reference(lead_a, lead_b):
    rng = np.random.default_rng(0)
    a, b = _affines(rng, *lead_a), _affines(rng, *lead_b)
    want = np.asarray(ref_types.compose_affine(jnp.asarray(a), jnp.asarray(b)))
    got = port_types.compose_affine(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("lead", [(), (6,), (2, 3)])
def test_invert_and_identity_match_reference(lead):
    a = _affines(np.random.default_rng(1), *lead)
    want = np.asarray(ref_types.invert_affine(jnp.asarray(a)))
    got = port_types.invert_affine(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    eye = port_types.identity_affine()
    np.testing.assert_array_equal(eye.numpy(), np.asarray(ref_types.identity_affine()))
    back = port_types.compose_affine(torch.from_numpy(a), got)
    np.testing.assert_allclose(back.numpy(), np.broadcast_to(eye.numpy(), back.shape), atol=1e-4)


@pytest.mark.parametrize("lead_a,lead_p", [((), (9,)), ((4,), (4,)), ((3, 1, 1), (5, 6))])
def test_apply_affine_matches_reference(lead_a, lead_p):
    rng = np.random.default_rng(2)
    a = _affines(rng, *lead_a)
    xy = rng.uniform(0, 1280, size=lead_p + (2,)).astype(np.float32)
    want = np.asarray(ref_types.apply_affine(jnp.asarray(a), jnp.asarray(xy)))
    got = port_types.apply_affine(torch.from_numpy(a), torch.from_numpy(xy))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2e-4)


def test_containers_are_frozen_dataclasses():
    clip = port_types.Clip.from_array(torch.zeros((3, 4, 5, 3)), fps=24)
    assert (clip.num_frames, clip.height, clip.width, clip.fps) == (3, 4, 5, 24.0)
    with pytest.raises(Exception):
        clip.fps = 1.0
    ff = port_types.FlowField(torch.ones((2, 4, 5, 2)))
    assert ff.u.shape == (2, 4, 5) and ff.v.shape == (2, 4, 5)
    assert port_types.CameraPath(torch.zeros((7, 2, 3))).num_frames == 7
    assert port_types.VertexGrid(torch.zeros((7, 2, 3, 2))).positions.shape == (7, 2, 3, 2)


def _affine_flow(rng, n, h, w, outliers=True):
    """Flow of a random near-identity affine per pair plus noise, with a
    block of independently moving pixels."""
    a = _affines(rng, n)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pts = np.stack([xx, yy], axis=-1)
    mapped = np.einsum("nij,hwj->nhwi", a[:, :, :2], pts) + a[:, None, None, :, 2]
    flow = mapped - pts[None] + rng.normal(scale=0.3, size=(n, h, w, 2))
    if outliers:
        flow[:, : h // 3, : w // 3] += rng.normal(scale=12.0, size=(n, 1, 1, 2))
    return flow.astype(np.float32), a


def _fit_f64(flow, step=16, iters=3):
    """The reference's IRLS in numpy float64."""
    n, h, w, _ = flow.shape
    ys = np.arange(step // 2, h, step)
    xs = np.arange(step // 2, w, step)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    xs, ys = xx.reshape(-1).astype(np.float64), yy.reshape(-1).astype(np.float64)
    xi, yi = xs.astype(np.int64), ys.astype(np.int64)
    X = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    out = []
    for f in flow.astype(np.float64):
        tx, ty = xs + f[yi, xi, 0], ys + f[yi, xi, 1]
        wgt = np.ones_like(tx)
        for _ in range(iters):
            XtW = X.T * wgt[None]
            sol = np.linalg.solve(XtW @ X + 1e-6 * np.eye(3), np.stack([XtW @ tx, XtW @ ty], -1))
            r = np.sqrt((X @ sol[:, 0] - tx) ** 2 + (X @ sol[:, 1] - ty) ** 2 + 1e-8)
            wgt = np.minimum(1.0, 1.345 * max(np.median(r), 1e-3) / r)
        out.append(sol.T)
    return np.stack(out)


# 720x1280 gives 45x80 = 3600 sample points (even: the median averages the
# two middle residuals); 72x104 gives 5x7 = 35 (odd); 64x96 gives 4x6 = 24.
@pytest.mark.parametrize("n,h,w", [(3, 720, 1280), (4, 72, 104), (5, 64, 96)])
def test_fit_affine_against_reference_and_float64(n, h, w):
    flow, _ = _affine_flow(np.random.default_rng(n), n, h, w)
    want = np.asarray(ref.fit_affine_from_flow(jnp.asarray(flow)))
    got = port.fit_affine_from_flow(torch.from_numpy(flow)).numpy()
    exact = _fit_f64(flow)
    assert got.shape == (n, 2, 3)
    for sl, floor, tol in ((np.s_[..., :2], 4e-6, 1e-5), (np.s_[..., 2], 2e-4, 5e-3)):
        err_ref = np.abs(want[sl] - exact[sl]).max()
        err_port = np.abs(got[sl] - exact[sl]).max()
        assert err_port <= max(2 * err_ref, floor), (err_port, err_ref)
        assert np.abs(got[sl] - want[sl]).max() <= tol


def test_fit_affine_median_is_the_mean_of_the_middle_pair():
    """An even point count where lower-median and averaged-median weights
    differ visibly: two samples rows far off the affine model."""
    rng = np.random.default_rng(11)
    flow, _ = _affine_flow(rng, 2, 32, 64, outliers=False)  # 2x4 = 8 points
    flow[:, 8, 8] += 5.0
    flow[:, 24, 40] -= 3.0
    want = np.asarray(ref.fit_affine_from_flow(jnp.asarray(flow)))
    got = port.fit_affine_from_flow(torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-3)


@pytest.mark.parametrize("t", [1, 2, 9, 300])
def test_chain_path_matches_reference(t):
    pair = _affines(np.random.default_rng(t), t - 1)
    pair[..., :2] = np.eye(2) + (pair[..., :2] - np.eye(2)) * 0.1  # stay bounded over 300 frames
    want = np.asarray(ref.chain_path(jnp.asarray(pair)).transforms)
    got = port.chain_path(torch.from_numpy(pair)).transforms.numpy()
    assert got.shape == (t, 2, 3)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=2e-3)
    # the order: C_{t+1} = A_t o C_t, serially in float64
    c = np.eye(3)
    for i in range(t - 1):
        c = np.vstack([pair[i].astype(np.float64), [0, 0, 1]]) @ c
    np.testing.assert_allclose(got[-1], c[:2], rtol=0, atol=5e-3)


# T = 9 and 20 are shorter than the Gaussian's radius int(3 * 9.0) = 27: the
# pad reflects repeatedly.
@pytest.mark.parametrize("t,sigma", [(9, 9.0), (20, 9.0), (28, 9.0), (60, 9.0), (30, 2.5), (5, 0.2)])
def test_smooth_path_matches_reference(t, sigma):
    tr = np.cumsum(_affines(np.random.default_rng(t), t) * 0.1, axis=0).astype(np.float32)
    want = np.asarray(ref.smooth_path(ref_types.CameraPath(jnp.asarray(tr)), sigma=sigma).transforms)
    got = port.smooth_path(port_types.CameraPath(torch.from_numpy(tr)), sigma=sigma).transforms
    assert got.shape == (t, 2, 3)
    np.testing.assert_allclose(got.numpy()[..., :2], want[..., :2], rtol=0, atol=5e-6)
    np.testing.assert_allclose(got.numpy()[..., 2], want[..., 2], rtol=0, atol=1e-4)


def test_stabilizing_transforms_and_smooth_affine_match_reference():
    rng = np.random.default_rng(5)
    t = 12
    orig = np.cumsum(_affines(rng, t) * 0.05, axis=0).astype(np.float32) + np.eye(2, 3, dtype=np.float32)
    sm = (orig + rng.normal(scale=0.01, size=orig.shape)).astype(np.float32)
    want = np.asarray(ref.stabilizing_transforms(
        ref_types.CameraPath(jnp.asarray(orig)), ref_types.CameraPath(jnp.asarray(sm))))
    got = port.stabilizing_transforms(
        port_types.CameraPath(torch.from_numpy(orig)), port_types.CameraPath(torch.from_numpy(sm)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

    flow, _ = _affine_flow(rng, t - 1, 64, 96)
    want = np.asarray(ref.smooth_affine(jnp.asarray(flow), sigma=4.0))
    got = port.smooth_affine(torch.from_numpy(flow), sigma=4.0).numpy()
    assert got.shape == (t, 2, 3)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=5e-3)
