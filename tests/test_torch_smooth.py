"""vstab_torch sparse-LS smoothing held against the JAX package on the CPU.

Tolerances. Vertex profiles (pooling and cumsum): 1e-4. The solves: the
temporal systems are ill-conditioned (lambda_accel=4000 against a data
weight of 1 gives a condition number near 6e4), so two f32 solvers that
round in another order differ by up to ~1e-4 of the solution's size. The
tests hold each solve to a float64 solve of the same equations: the port
must be no further from it than twice the reference's distance (plus 1e-5),
and within 5e-3 px of the reference on paths of +-25 px.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstab.core.config import SmoothConfig as SmoothRef
from vstab.smooth import sparse_ls as ref
from vstab.smooth.banded import banded_matvec as matvec_ref
from vstab.smooth.banded import banded_solve_scan as banded_ref
from vstab.smooth.schur import schur_solve as schur_ref
from vstab_torch.core.config import SmoothConfig
from vstab_torch.smooth import sparse_ls as port
from vstab_torch.smooth.banded import banded_matvec, banded_solve_scan
from vstab_torch.smooth.schur import schur_solve

torch.set_num_threads(1)
ATOL = 1e-4


def _system(t, m, seed):
    rng = np.random.default_rng(seed)
    d0, d1, d2 = ref.temporal_diagonals(t, 400.0, 4000.0)
    alpha = 1.0 + 10.0 * rng.random(m).astype(np.float32)
    d0 = (d0[:, None] + alpha[None]).astype(np.float32) + np.float32(1e-4)
    d1 = np.broadcast_to(d1[:, None], (t - 1, m)).astype(np.float32)
    d2 = np.broadcast_to(d2[:, None], (t - 2, m)).astype(np.float32)
    b = rng.normal(scale=20.0, size=(t, m)).astype(np.float32)
    return d0, d1, d2, b


def _flow(t, h, w, seed):
    """Flow of a shaking camera (translation and roll about a fixed pose),
    with noise and a patch that moves on its own."""
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    pos = np.empty((t + 1, h, w, 2), np.float32)
    for i in range(t + 1):
        shake = rng.normal(scale=4.0, size=2)
        rot = rng.normal(scale=0.01)
        pos[i, ..., 0] = shake[0] - rot * (gy - h / 2)
        pos[i, ..., 1] = shake[1] + rot * (gx - w / 2)
    out = pos[1:] - pos[:-1]
    out += rng.normal(scale=0.3, size=out.shape).astype(np.float32)
    out[:, : h // 4, : w // 4] += np.where(np.arange(t) % 2, 6.0, -6.0)[:, None, None, None]
    return out


def _solve64(d0, d1, d2, b):
    """Dense float64 solve of each column's pentadiagonal system."""
    t, m = d0.shape
    x = np.empty((t, m))
    for j in range(m):
        a = np.diag(d0[:, j].astype(np.float64))
        for k, d in ((1, d1[:, j]), (2, d2[:, j])):
            a += np.diag(d.astype(np.float64), k) + np.diag(d.astype(np.float64), -k)
        x[:, j] = np.linalg.solve(a, b[:, j].astype(np.float64))
    return x


def _smooth64(c, cfg):
    """float64 smoothed profiles for profiles c [T,GH,GW,2] (the normal
    equations of sparse_ls.smooth_profiles, solved densely)."""
    t, gh, gw, _ = c.shape
    v, mu = (x.astype(np.float64) for x in ref.spatial_modes(gh, gw))
    td0, td1, td2 = ref.temporal_diagonals(t, cfg.lambda_smooth, cfg.lambda_accel)
    alpha = cfg.lambda_data + cfg.lambda_rigid * mu
    ctil = np.einsum("ig,tic->tgc", v, c.reshape(t, -1, 2).astype(np.float64))
    m = 2 * gh * gw
    d0 = td0[:, None] + np.repeat(alpha, 2)[None] + cfg.damping
    ptil = _solve64(
        d0, np.broadcast_to(td1[:, None], (t - 1, m)), np.broadcast_to(td2[:, None], (t - 2, m)),
        (alpha[None, :, None] * ctil).reshape(t, m),
    )
    return np.einsum("ig,tgc->tic", v, ptil.reshape(t, -1, 2)).reshape(c.shape)


def _no_worse(got, want, exact, atol):
    """got is within atol of want, and no further from exact than twice
    want's distance plus 1e-5."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= atol
    assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max() + 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_host_builders_equal_reference():
    for gh, gw in ((12, 16), (3, 5)):
        for a, b in zip(port.spatial_modes(gh, gw), ref.spatial_modes(gh, gw)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(port.temporal_diagonals(41, 400.0, 4000.0), ref.temporal_diagonals(41, 400.0, 4000.0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port._pool_matrices(37, 50, 12, 16), ref._pool_matrices(37, 50, 12, 16)):
        np.testing.assert_array_equal(a, b)


def test_banded_solve_matches_reference():
    d0, d1, d2, b = _system(40, 24, 0)
    want = banded_ref(*(jnp.asarray(x) for x in (d0, d1, d2, b)))
    got = banded_solve_scan(*(_t(x) for x in (d0, d1, d2, b)))
    _no_worse(got.numpy(), want, _solve64(d0, d1, d2, b), atol=5e-3)


def _spd_penta(t, m, seed):
    """Random SPD pentadiagonal bands [T, M], [T-1, M], [T-2, M]: the
    diagonal dominates each row's off-diagonal entries by 4."""
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(t - 1, m)).astype(np.float32)
    d2 = rng.normal(size=(t - 2, m)).astype(np.float32)
    a1, a2 = np.abs(d1), np.abs(d2)
    d0 = np.full((t, m), 4.0, np.float32)
    d0[1:] += a1
    d0[:-1] += a1
    d0[2:] += a2
    d0[:-2] += a2
    return d0, d1, d2


@pytest.mark.parametrize("t", [3, 5, 64])
def test_banded_matvec_matches_reference(t):
    """y = A x against the JAX function, within 1e-6 of the largest |y|."""
    d0, d1, d2 = _spd_penta(t, 7, t)
    x = np.random.default_rng(100 + t).normal(size=(t, 7)).astype(np.float32)
    want = np.asarray(matvec_ref(*(jnp.asarray(a) for a in (d0, d1, d2, x))))
    got = banded_matvec(*(_t(a) for a in (d0, d1, d2, x))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("t", [3, 5, 64])
def test_banded_solve_inverts_banded_matvec(t):
    """The solve of A x gives x back on a diagonally dominant SPD band."""
    d0, d1, d2 = (_t(a) for a in _spd_penta(t, 7, t))
    x = _t(np.random.default_rng(200 + t).normal(size=(t, 7)).astype(np.float32))
    back = banded_solve_scan(d0, d1, d2, banded_matvec(d0, d1, d2, x))
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t,block_len", [(100, 32), (96, 16)])
def test_schur_solve_matches_reference_and_banded(t, block_len):
    d0, d1, d2, b = _system(t, 24, 1)
    want = schur_ref(*(jnp.asarray(x) for x in (d0, d1, d2, b)), block_len=block_len)
    got = schur_solve(*(_t(x) for x in (d0, d1, d2, b)), block_len=block_len)
    exact = _solve64(d0, d1, d2, b)
    _no_worse(got.numpy(), want, exact, atol=5e-3)
    banded = banded_solve_scan(*(_t(x) for x in (d0, d1, d2, b)))
    _no_worse(got.numpy(), banded.numpy(), exact, atol=5e-3)


@pytest.mark.parametrize("robust_iters", [0, 2])
def test_vertex_profiles_match_reference(robust_iters):
    flow = _flow(6, 36, 48, 2)
    want = ref.vertex_profiles(jnp.asarray(flow), (12, 16), robust_iters)
    got = port.vertex_profiles(_t(flow), (12, 16), robust_iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("t", [40, 100])
def test_smooth_grid_field_matches_reference(t):
    # T=40 takes the banded solve, T=100 (>= 3*block_len) the Schur solve.
    flow = _flow(t - 1, 36, 48, 3)
    cfg_r, cfg_p = SmoothRef(block_len=32), SmoothConfig(block_len=32)
    disp_r, diags_r = ref.smooth_grid_field(jnp.asarray(flow), (36, 48), cfg_r)
    disp_p, diags_p = port.smooth_grid_field(_t(flow), (36, 48), cfg_p)
    assert disp_p.shape == (t, 12, 16, 2)
    c = np.asarray(diags_r["profiles"])
    np.testing.assert_allclose(diags_p["profiles"].numpy(), c, rtol=0, atol=ATOL)
    p64 = _smooth64(c, cfg_r)
    _no_worse(diags_p["smoothed"].numpy(), diags_r["smoothed"], p64, atol=5e-3)
    _no_worse(disp_p.numpy(), disp_r, c - p64, atol=5e-3)


def test_smooth_profiles_options_match_reference():
    c = np.cumsum(np.random.default_rng(5).normal(size=(30, 4, 6, 2)), axis=0).astype(np.float32)
    kw = dict(lambda_accel=0.0, lambda_rigid=3.0, damping=1e-3)
    want = ref.smooth_profiles(jnp.asarray(c), dataclasses.replace(SmoothRef(), **kw))
    got = port.smooth_profiles(_t(c), dataclasses.replace(SmoothConfig(), **kw))
    exact = _smooth64(c, dataclasses.replace(SmoothRef(), **kw))
    _no_worse(got.numpy(), want, exact, atol=5e-3)
