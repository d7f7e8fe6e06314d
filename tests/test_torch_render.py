"""vstab_torch renderer held against the JAX package on the CPU.

Tolerances: 1e-5 for resampling matrices and the zoom, 1e-5 relative for
dense flows (the two resizers weight the same taps, rounded apart), 1e-4 for
rendered frames (the two-pass warp's fixed-point iterates and the zoom's
source coordinates round f32 in another order).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstab.core.config import RenderConfig as RenderRef
from vstab.render import render as ref
from vstab_torch.core.config import RenderConfig
from vstab_torch.render import render as port
from torch_zoom_tent import tent_zoom

torch.set_num_threads(1)


def _path(rng, t, gh, gw, scale):
    return rng.normal(scale=scale, size=(t, gh, gw, 2)).astype(np.float32)


def test_grid_to_flow_matches_reference():
    path = _path(np.random.default_rng(0), 3, 12, 16, 5.0)
    want = ref.grid_to_flow(jnp.asarray(path), 72, 100)
    got = port.grid_to_flow(torch.from_numpy(path), 72, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g,n", [(12, 720), (16, 1280), (5, 37), (6, 6)])
def test_resize_mean_weights_match_reference(g, n):
    np.testing.assert_allclose(
        np.asarray(port._resize_mean_weights(g, n)),
        np.asarray(ref._resize_mean_weights(g, n)), rtol=0, atol=1e-6,
    )


def test_residual_disp_bound_and_bucket_match_reference():
    rng = np.random.default_rng(1)
    for scale in (2.0, 9.0, 20.0, 60.0, 150.0):
        path = _path(rng, 5, 12, 16, scale)
        b_ref = ref.residual_disp_bound(path, 720, 1280, "sparse_ls")
        b_port = port.residual_disp_bound(path, 720, 1280, "sparse_ls")
        assert abs(b_ref - b_port) < 1e-4
        assert port.pick_max_disp(b_port, RenderConfig()) == ref.pick_max_disp(b_ref, RenderRef())


@pytest.mark.parametrize(
    "bound", [0.0, 3.0, 15.4, 15.6, 20.0, 30.0, 47.5, 62.6, 100.0, 200.0, 254.4, 300.0]
)
def test_pick_max_disp_buckets_match_reference(bound):
    for kw in ({}, {"adaptive_max_disp": False}, {"max_disp_limit": 48}, {"max_residual_disp": 24}):
        assert port.pick_max_disp(bound, RenderConfig(**kw)) == ref.pick_max_disp(bound, RenderRef(**kw))


def test_pick_max_disp_warns_only_where_the_reference_does(caplog):
    with caplog.at_level(logging.WARNING):
        assert port.pick_max_disp(300.0, RenderConfig()) == 255
        assert port.pick_max_disp(100.0, RenderConfig(max_disp_limit=48)) == 48
    assert len([r for r in caplog.records if r.name == "vstab_torch.render"]) == 1


def test_zoom_and_auto_scale_match_reference():
    rng = np.random.default_rng(2)
    img = rng.random((2, 30, 44, 3)).astype(np.float32)
    for s in (0.9, 0.62):
        want = ref.zoom_resample(jnp.asarray(img), jnp.float32(s))
        got = port.zoom_resample(torch.from_numpy(img), torch.tensor(s, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    flow = rng.normal(scale=4.0, size=(3, 30, 44, 2)).astype(np.float32)
    np.testing.assert_allclose(
        port._auto_scale_per_frame(torch.from_numpy(flow)).numpy(),
        np.asarray(ref._auto_scale_per_frame(jnp.asarray(flow))), rtol=0, atol=1e-6,
    )


# The zoom's two-tap passes against the dense tent product they replace: the
# same taps and weights, apart from the f32 rounding of the source coordinate.
@pytest.mark.parametrize("scale", [1.0, 0.9, 0.62, 0.5])
@pytest.mark.parametrize("shape", [(2, 30, 44, 3), (1, 37, 53, 1), (3, 64, 96, 3)])
def test_zoom_resample_matches_the_tent_product(shape, scale):
    img = torch.from_numpy(np.random.default_rng(4).random(shape).astype(np.float32))
    s = torch.tensor(scale, dtype=torch.float32)
    np.testing.assert_allclose(
        port.zoom_resample(img, s).numpy(), tent_zoom(img, s).numpy(), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("scale", [1.0, 0.9, 0.62, 0.5])
def test_zoomed_mask_keeps_the_tent_products_validity(scale):
    """A validity mask with invalid border rows and columns and a few invalid
    pixels inside: the render's `> 0.999` test on the zoomed mask decides
    every pixel as it does on the tent product's."""
    t, h, w = 2, 45, 67
    mask = torch.ones((t, h, w, 1))
    mask[0, :3], mask[0, :, -5:], mask[1, -2:], mask[1, :, :4] = 0.0, 0.0, 0.0, 0.0
    mask[:, 20, 30] = 0.0
    s = torch.tensor(scale, dtype=torch.float32)
    fields = port.zoom_fields((t, h, w), s)
    got = port.zoom_resample(mask, s, fields) > 0.999
    want = tent_zoom(mask, s) > 0.999
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("crop_mode", ["fixed", "auto", "none"])
def test_render_span_counts_the_zoom_passes(crop_mode):
    from vstab_torch.utils import trace

    frames = torch.rand((2, 24, 32, 3))
    flow = torch.full((2, 24, 32, 2), 1.5)
    trace.clear()
    with trace.recording():
        port.render_stabilized(frames, flow, RenderConfig(crop_mode=crop_mode))
    (rec,) = [r for r in trace.records() if r["name"] == "vstab.render"]
    trace.clear()
    assert rec["attrs"]["zoom_passes"] == (0 if crop_mode == "none" else 4)


@pytest.mark.parametrize("crop_mode", ["fixed", "auto", "none"])
@pytest.mark.parametrize("max_disp", [16, 63])
def test_render_stabilized_matches_reference(crop_mode, max_disp):
    rng = np.random.default_rng(3)
    t, h, w = 3, 40, 56
    frames = rng.random((t, h, w, 3)).astype(np.float32)
    path = _path(rng, t, 4, 6, 3.0) + rng.normal(scale=8.0, size=(t, 1, 1, 2)).astype(np.float32)
    flow_r = ref.grid_to_flow(jnp.asarray(path), h, w)
    flow_p = port.grid_to_flow(torch.from_numpy(path), h, w)
    want = ref.render_stabilized(
        jnp.asarray(frames), flow_r, RenderRef(crop_mode=crop_mode, kernel_impl="xla"),
        max_disp=max_disp,
    )
    got = port.render_stabilized(
        torch.from_numpy(frames), flow_p, RenderConfig(crop_mode=crop_mode), max_disp=max_disp
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def _warps(rng, t, shift=6.0, lin=0.01):
    a = np.zeros((t, 2, 3), np.float32)
    a[:, :, :2] = np.eye(2) + rng.normal(scale=lin, size=(t, 2, 2))
    a[:, :, 2] = rng.normal(scale=shift, size=(t, 2))
    return a


# Flow values reach tens of pixels: 1e-5 relative, 1e-4 px absolute.
def test_affine_to_flow_matches_reference():
    warps = _warps(np.random.default_rng(4), 5)
    want = ref.affine_to_flow(jnp.asarray(warps), 72, 100)
    got = port.affine_to_flow(torch.from_numpy(warps), 72, 100)
    assert got.shape == (5, 72, 100, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lin", [0.002, 0.02, 0.1])
def test_affine_residual_disp_bound_equals_reference(lin):
    warps = _warps(np.random.default_rng(5), 7, lin=lin)
    for h, w in ((720, 1280), (1080, 1920), (64, 96)):
        b_ref = ref.residual_disp_bound(warps, h, w, "affine")
        b_port = port.residual_disp_bound(warps, h, w, "affine")
        assert b_port == b_ref  # the same numpy arithmetic
        assert port.pick_max_disp(b_port, RenderConfig()) == ref.pick_max_disp(b_ref, RenderRef())
    assert port.residual_disp_bound(np.zeros((0, 2, 3), np.float32), 64, 96, "affine") == 0.0
    # the bound covers the dense flow's mean-removed residual
    flow = port.affine_to_flow(torch.from_numpy(warps), 64, 96)
    res = (flow - flow.mean(dim=(1, 2), keepdim=True)).abs().max()
    assert float(res) <= port.residual_disp_bound(warps, 64, 96, "affine") + 1e-3


@pytest.mark.parametrize("crop_mode", ["fixed", "auto"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_render_scale_override_matches_reference(crop_mode, as_tensor):
    rng = np.random.default_rng(6)
    t, h, w = 3, 40, 56
    frames = rng.random((t, h, w, 3)).astype(np.float32)
    warps = _warps(rng, t, shift=3.0)
    want = ref.render_stabilized(
        jnp.asarray(frames), ref.affine_to_flow(jnp.asarray(warps), h, w),
        RenderRef(crop_mode=crop_mode, kernel_impl="xla"), scale=jnp.float32(0.8), max_disp=24,
    )
    flow = port.affine_to_flow(torch.from_numpy(warps), h, w)
    scale = torch.tensor(0.8) if as_tensor else 0.8
    got = port.render_stabilized(
        torch.from_numpy(frames), flow, RenderConfig(crop_mode=crop_mode), scale=scale, max_disp=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    plain = port.render_stabilized(torch.from_numpy(frames), flow, RenderConfig(crop_mode=crop_mode), max_disp=24)
    assert not torch.equal(plain, got)  # the override is what zoomed


def test_render_affine_and_render_grid_match_reference():
    rng = np.random.default_rng(7)
    t, h, w = 3, 40, 56
    frames = rng.random((t, h, w, 3)).astype(np.float32)
    warps = _warps(rng, t, shift=3.0)
    want = ref.render_affine(jnp.asarray(frames), jnp.asarray(warps), RenderRef(kernel_impl="xla"))
    got = port.render_affine(torch.from_numpy(frames), torch.from_numpy(warps), RenderConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    path = _path(rng, t, 4, 6, 2.0)
    want = ref.render_grid(jnp.asarray(frames), jnp.asarray(path), RenderRef(kernel_impl="xla"))
    got = port.render_grid(torch.from_numpy(frames), torch.from_numpy(path), RenderConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
