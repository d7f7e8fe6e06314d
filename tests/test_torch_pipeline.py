"""vstab_torch whole-clip pipeline held against the JAX package on the CPU.

Tolerance for `stabilize` (flow_086000, f32): the same render bucket, and
output within 1e-3 of the reference on at least 99.9% of the pixels (the
rest sit where the 0.999 validity threshold or a bilinear tap flips).
"""

import dataclasses
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstab.core.config as jcfg
from vstab.eval.synthetic import make_shaky_clip as make_shaky_clip_ref
from vstab.flow.pwcnet import init_params
from vstab.pipeline import _clip_flow as clip_flow_ref
from vstab.pipeline import stabilize as stabilize_ref
from vstab.render.render import pick_max_disp as pick_ref
from vstab.render.render import residual_disp_bound as bound_ref
from vstab.utils.checkpoint import load_params as load_params_ref
import vstab_torch
from vstab_torch.core import config as tcfg
from vstab_torch.eval.synthetic import make_shaky_clip
from vstab_torch.pipeline import _params_match, clip_flow, default_params, resolve_device
from vstab_torch.render.render import pick_max_disp, residual_disp_bound
from vstab_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = os.path.join(REPO, "ckpts")


def _cfg(mod, **flow):
    return mod.Config(
        flow=mod.FlowConfig(kernel_impl="xla", compute_dtype="float32", **flow),
        render=mod.RenderConfig(kernel_impl="xla"),
    )


def test_stabilize_matches_reference():
    frames, _ = make_shaky_clip(t=9, h=64, w=96, seed=0)
    want, diags_r = stabilize_ref(
        jnp.asarray(frames), load_params_ref(os.path.join(CKPTS, "flow_086000.msgpack")),
        _cfg(jcfg),
    )
    params = default_params(_cfg(tcfg), ckpt_dir=CKPTS, device="cpu")
    got, diags_p = vstab_torch.stabilize(frames, params, _cfg(tcfg), device="cpu")
    assert got.shape == (9, 64, 96, 3) and got.dtype == torch.float32
    assert torch.isfinite(got).all()

    def bucket(diags, bound_fn, pick_fn, render_cfg):
        path = np.asarray(diags["profiles"]) - np.asarray(diags["smoothed"])
        return pick_fn(bound_fn(path, 64, 96, "sparse_ls"), render_cfg)

    assert bucket(diags_p, residual_disp_bound, pick_max_disp, tcfg.RenderConfig()) == bucket(
        diags_r, bound_ref, pick_ref, jcfg.RenderConfig()
    )
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= 1e-3).mean() >= 0.999, (err.max(), (err > 1e-3).mean())


def test_clip_flow_chunks_match_reference():
    tiny = dict(
        pyramid_channels=(8, 16, 24), estimator_channels=(16, 16),
        context_dilations=(1, 2, 1), search_radius=2, output_level=2,
    )
    jp = init_params(jax.random.PRNGKey(1), _cfg(jcfg, **tiny).flow)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    frames = np.random.default_rng(0).random((8, 24, 40, 3)).astype(np.float32)
    want = clip_flow_ref(jp, jnp.asarray(frames), _cfg(jcfg, **tiny), pair_chunk=3)
    got = clip_flow(tp, torch.from_numpy(frames), _cfg(tcfg, **tiny), pair_chunk=3)
    assert got.shape == (7, 24, 40, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    whole = clip_flow(tp, torch.from_numpy(frames), _cfg(tcfg, **tiny))
    np.testing.assert_allclose(whole.numpy(), got.numpy(), rtol=0, atol=1e-5)


def test_stabilize_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    frames = np.zeros((3, 64, 64, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vstab_torch.stabilize(frames, {}, vstab_torch.Config())
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_default_params_checkpoint_and_mismatch(caplog):
    params = default_params(vstab_torch.Config(), ckpt_dir=CKPTS, device="cpu")
    assert len(params) == 126 and _params_match(params, tcfg.FlowConfig())
    assert sum(v.numel() for v in params.values()) == 10_176_650
    small = dataclasses.replace(
        vstab_torch.Config(), flow=tcfg.FlowConfig(pyramid_channels=(8, 16), output_level=1)
    )
    with caplog.at_level(logging.WARNING):
        fresh = default_params(small, ckpt_dir=CKPTS, device="cpu", seed=3)
    assert "does not match" in caplog.text
    assert _params_match(fresh, small.flow)
    again = default_params(small, ckpt_dir=CKPTS, device="cpu", seed=3)
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)


def test_synthetic_clip_matches_reference_numpy_path(monkeypatch):
    # The reference renders with OpenCV when present; block it so both take
    # the numpy sampler.
    monkeypatch.setitem(sys.modules, "cv2", None)
    want, cams_r = make_shaky_clip_ref(t=4, h=40, w=56, seed=2)
    got, cams = make_shaky_clip(t=4, h=40, w=56, seed=2)
    np.testing.assert_array_equal(cams, cams_r)
    np.testing.assert_array_equal(got, want)


def _cfg_method(mod, method, **render):
    return mod.Config(
        flow=mod.FlowConfig(kernel_impl="xla", compute_dtype="float32"),
        smooth=mod.SmoothConfig(method=method),
        render=mod.RenderConfig(kernel_impl="xla", **render),
    )


# Affine path, flow_086000 in f32. The diagnostics (trajectory of up to tens
# of pixels) within 2e-5 on the linear part and 5e-3 px on the translation;
# the same render bucket; output within 1e-3 on at least 99.9% of the pixels.
def test_stabilize_affine_matches_reference():
    frames, _ = make_shaky_clip(t=9, h=64, w=96, seed=0)
    want, diags_r = stabilize_ref(
        jnp.asarray(frames), load_params_ref(os.path.join(CKPTS, "flow_086000.msgpack")),
        _cfg_method(jcfg, "affine"),
    )
    cfg = _cfg_method(tcfg, "affine")
    params = default_params(cfg, ckpt_dir=CKPTS, device="cpu")
    got, diags_p = vstab_torch.stabilize(frames, params, cfg, device="cpu")
    assert got.shape == (9, 64, 96, 3) and torch.isfinite(got).all()
    assert set(diags_p) == set(diags_r) == {"warps", "path", "smoothed"}
    for k in diags_p:
        a, b = diags_p[k].numpy(), np.asarray(diags_r[k])
        np.testing.assert_allclose(a[..., :2], b[..., :2], rtol=0, atol=2e-5, err_msg=k)
        np.testing.assert_allclose(a[..., 2], b[..., 2], rtol=0, atol=5e-3, err_msg=k)
    assert pick_max_disp(
        residual_disp_bound(diags_p["warps"].numpy(), 64, 96, "affine"), tcfg.RenderConfig()
    ) == pick_ref(bound_ref(np.asarray(diags_r["warps"]), 64, 96, "affine"), jcfg.RenderConfig())
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= 1e-3).mean() >= 0.999, (err.max(), (err > 1e-3).mean())
    clip = vstab_torch.stabilize_clip(
        vstab_torch.core.types.Clip.from_array(torch.from_numpy(frames), fps=24.0), params, cfg, device="cpu")
    assert clip.fps == 24.0 and torch.equal(clip.frames, got)


_TINY = dict(
    pyramid_channels=(8, 12, 16), estimator_channels=(16, 12), output_level=1,
)


def _tiny_cfg(mod, method, adaptive=True):
    return mod.Config(
        flow=mod.FlowConfig(kernel_impl="xla", compute_dtype="float32", **_TINY),
        smooth=mod.SmoothConfig(method=method, grid_size=(4, 4)),
        render=mod.RenderConfig(kernel_impl="xla", crop_mode="auto", adaptive_max_disp=adaptive),
    )


# A tiny random network (flows of a few pixels): batch output within 1e-3 of
# the reference's on 99.9% of the pixels, and within 1e-5 of per-clip
# `stabilize` wherever that picks the batch's bucket.
@pytest.mark.parametrize("method", ["sparse_ls", "affine"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_stabilize_batch_matches_reference_and_per_clip(method, adaptive):
    from vstab.pipeline import stabilize_batch as batch_ref

    jp = init_params(jax.random.PRNGKey(2), _tiny_cfg(jcfg, method).flow)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    a, _ = make_shaky_clip(t=7, h=48, w=64, seed=1)
    frames = np.stack([a, a[::-1]])
    want = np.asarray(batch_ref(jnp.asarray(frames), jp, _tiny_cfg(jcfg, method, adaptive)))
    cfg = _tiny_cfg(tcfg, method, adaptive)
    got = vstab_torch.stabilize_batch(frames, tp, cfg, device="cpu")
    assert got.shape == (2, 7, 48, 64, 3) and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-3).mean() >= 0.999, (err.max(), (err > 1e-3).mean())
    for i in range(2):
        one, _ = vstab_torch.stabilize(frames[i], tp, cfg, device="cpu")
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=0, atol=1e-5)


def test_stabilize_batch_takes_the_largest_bucket(monkeypatch):
    """Two still clips, the second one's solved path pushed out by 40 px at
    a vertex: the batch renders both with the second clip's bucket."""
    from vstab_torch import pipeline as pl

    cfg = _tiny_cfg(tcfg, "sparse_ls")
    tp = default_params(cfg, ckpt_dir="/nonexistent", device="cpu", seed=0)
    still = np.broadcast_to(make_shaky_clip(t=1, h=48, w=64, seed=3)[0], (6, 48, 64, 3))
    seen, calls = [], []
    real_render, real_paths = pl.render_stabilized, pl.smooth_paths

    def paths(flow, c, hw):
        path, diags = real_paths(flow, c, hw)
        calls.append(1)
        if len(calls) == 2:  # the second clip: 40 px more at one corner vertex
            path = path.clone()
            path[:, 0, 0, 0] += 40.0
        return path, diags

    def render(fr, fl, rc, scale=None, max_disp=None):
        seen.append(max_disp)
        return real_render(fr, fl, rc, scale=scale, max_disp=max_disp)

    monkeypatch.setattr(pl, "smooth_paths", paths)
    monkeypatch.setattr(pl, "render_stabilized", render)
    vstab_torch.stabilize_batch(np.stack([still, still]), tp, cfg, device="cpu")
    assert len(seen) == 2 and seen[0] == seen[1] and seen[0] > 16, seen
