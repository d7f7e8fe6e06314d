"""vstab_torch's flow trainer held against the JAX package on the CPU, f32,
the same numpy inputs through both (JAX with `kernel_impl="xla"`).

Tolerances: resizes, losses and the schedule 1e-5 abs (the same f32
arithmetic, sums in another order); batches from JAX-made draws 1e-4 (a chain
of resize, warp and blends on values up to about 30 px); loss and every
leaf's gradient relative 1e-3 of that leaf's largest value (convolutions and
their transposes sum in other orders through up to six levels); optimizer
steps 1e-5 abs on parameters of order 0.1.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vstab.core.config as jcfg
import vstab.flow.train as jtrain
from vstab.flow.pwcnet import PWCNet as PWCNetRef, init_params as init_params_ref
from vstab_torch.core import config as tcfg
from vstab_torch.flow import train as ttrain
from vstab_torch.flow.pwcnet import build_net, init_params
from vstab_torch.kernels import bilinear_warp_plain
from vstab_torch.utils.checkpoint import load_params, params_from_jax, params_to_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "ckpts", "flow_086000.msgpack")

# tests/flow/test_train.py:TINY
_TINY = dict(
    pyramid_channels=(8, 16, 24), estimator_channels=(16, 16), context_dilations=(1, 2, 1),
    search_radius=2, kernel_impl="xla", compute_dtype="float32", output_level=2,
)
_FULL = dict(kernel_impl="xla", compute_dtype="float32")


def _rand(rng, shape, lo=-1.0, hi=1.0):
    return (rng.random(shape) * (hi - lo) + lo).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


# ---------------------------------------------------------------------------
# Resizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [4, 8, 16, 32, 64])
def test_antialiased_linear_resize_matches_jax(ratio):
    """The trainer's shrink ratios 1/4 .. 1/64 of the ground-truth flow."""
    rng = np.random.default_rng(ratio)
    x = _rand(rng, (2, 128, 192, 2), -12.0, 12.0)
    hw = (128 // ratio, 192 // ratio)
    want = jax.image.resize(jnp.asarray(x), (2, *hw, 2), method="linear")
    _close(ttrain._resize_linear(_t(x), hw), want, 1e-5)


def test_plain_bilinear_is_not_jax_linear_when_shrinking():
    """Why `_resize_linear` asks for antialiasing: without it the error is
    of the order of the values."""
    rng = np.random.default_rng(0)
    x = _rand(rng, (1, 64, 64, 2), -12.0, 12.0)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 8, 8, 2), method="linear"))
    plain = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), size=(8, 8), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)
    assert np.abs(plain.numpy() - want).max() > 1.0


@pytest.mark.parametrize("hw", [(64, 96), (33, 47), (192, 256)])
def test_keys_bicubic_upsample_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    coarse = _rand(rng, (3, 4, 5, 2))  # the unit grid that both trainers scale by max_disp
    want = jax.image.resize(jnp.asarray(coarse), (3, *hw, 2), "bicubic")
    _close(ttrain._resize_cubic(_t(coarse), hw), want, 1e-5)


def test_torch_bicubic_is_not_jax_bicubic():
    """Why `_resize_cubic` builds its own weights: torch's a = -0.75 kernel
    with clamped indices is another function."""
    rng = np.random.default_rng(1)
    coarse = _rand(rng, (1, 4, 5, 2), -12.0, 12.0)
    want = np.asarray(jax.image.resize(jnp.asarray(coarse), (1, 64, 96, 2), "bicubic"))
    other = torch.nn.functional.interpolate(
        _t(coarse).permute(0, 3, 1, 2), size=(64, 96), mode="bicubic", align_corners=False
    ).permute(0, 2, 3, 1)
    assert np.abs(other.numpy() - want).max() > 0.1


@pytest.mark.parametrize("hw", [(16, 24), (4, 6), (1, 1)])
def test_pool_flow_to_matches_jax(hw):
    rng = np.random.default_rng(2)
    flow = _rand(rng, (2, 64, 96, 2), -12.0, 12.0)
    _close(ttrain._pool_flow_to(_t(flow), hw), jtrain._pool_flow_to(jnp.asarray(flow), hw), 1e-5)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _pyramid(rng, n, h, w, levels):
    return [_rand(rng, (n, h >> l, w >> l, 2), -3.0, 3.0) for l in levels]


@pytest.mark.parametrize("levels", [(6, 5, 4, 3, 2), (3, 2), (7, 6, 5, 4, 3, 2)])
def test_multiscale_epe_matches_jax(levels):
    rng = np.random.default_rng(3)
    h, w = 128, 128
    pyr = _pyramid(rng, 2, h, w, levels)
    gt = _rand(rng, (2, h, w, 2), -12.0, 12.0)
    want, aux_w = jtrain.multiscale_epe(tuple(jnp.asarray(p) for p in pyr), jnp.asarray(gt))
    got, aux = ttrain.multiscale_epe([_t(p) for p in pyr], _t(gt))
    _close(got, want, 1e-5)
    _close(aux["epe_finest"], aux_w["epe_finest"], 1e-5)


def test_multiscale_epe_zero_for_perfect():
    loss, aux = ttrain.multiscale_epe(
        [torch.zeros((1, 4, 4, 2)), torch.zeros((1, 8, 8, 2))], torch.zeros((1, 32, 32, 2))
    )
    assert float(loss) < 1e-3 and float(aux["epe_finest"]) < 1e-3


def test_photometric_loss_matches_jax():
    rng = np.random.default_rng(4)
    im1, im2 = _rand(rng, (2, 64, 96, 3), 0, 1), _rand(rng, (2, 64, 96, 3), 0, 1)
    pyr = _pyramid(rng, 2, 64, 96, (3, 2))
    want, aux_w = jtrain.photometric_loss(
        jnp.asarray(im1), jnp.asarray(im2), tuple(jnp.asarray(p) for p in pyr), jcfg.FlowConfig(**_TINY)
    )
    got, aux = ttrain.photometric_loss(_t(im1), _t(im2), [_t(p) for p in pyr], tcfg.FlowConfig(**_TINY))
    _close(got, want, 1e-5)
    for k in ("photo", "smooth"):
        _close(aux[k], aux_w[k], 1e-5)


def test_photometric_loss_gradient_to_the_flow_matches_jax():
    rng = np.random.default_rng(5)
    im1, im2 = _rand(rng, (2, 32, 48, 3), 0, 1), _rand(rng, (2, 32, 48, 3), 0, 1)
    fl = _rand(rng, (2, 8, 12, 2), -3.0, 3.0)
    want = jax.grad(lambda f: jtrain.photometric_loss(
        jnp.asarray(im1), jnp.asarray(im2), (f,), jcfg.FlowConfig(**_TINY))[0])(jnp.asarray(fl))
    f = _t(fl).requires_grad_()
    ttrain.photometric_loss(_t(im1), _t(im2), [f], tcfg.FlowConfig(**_TINY))[0].backward()
    _close(f.grad, want, 1e-3 * float(np.abs(np.asarray(want)).max()))


# ---------------------------------------------------------------------------
# Batches: the draws made by jax.random as the JAX functions split and fold
# their keys, the rest by the port.
# ---------------------------------------------------------------------------


def _u(key, shape, lo=-1.0, hi=1.0):
    return _t(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _jax_occluder_draws(kocc, n, s, h, w, n_occ=3):
    out = []
    for j in range(n_occ):
        ktex, kgeo, kmove, kon = jax.random.split(jax.random.fold_in(kocc, j), 4)
        out.append({
            "tex": _t(jax.random.randint(ktex, (n,), 0, s)).long(),
            "cy": _u(kgeo, (n,), 0.15 * h, 0.85 * h),
            "cx": _u(jax.random.fold_in(kgeo, 1), (n,), 0.15 * w, 0.85 * w),
            "ry": _u(jax.random.fold_in(kgeo, 2), (n,), h / 7.0, h / 3.5),
            "rx": _u(jax.random.fold_in(kgeo, 3), (n,), w / 7.0, w / 3.5),
            "move": _u(kmove, (n, 2)),
            "on": _t(jax.random.uniform(kon, (n,))),
        })
    return out


def _jax_sample_draws(rng, n, s, h, w, occluders):
    kidx, kaff, kgrid, kbr, kbl, kocc = jax.random.split(rng, 6)
    return {
        "idx": _t(jax.random.randint(kidx, (n,), 0, s)).long(),
        "blur": _t(jax.random.randint(kbl, (n,), 0, 8)).long(),
        "angle": _u(kaff, (n,)),
        "scale": _u(jax.random.fold_in(kaff, 1), (n,)),
        "txy": _u(jax.random.fold_in(kaff, 2), (n, 2)),
        "coarse": _u(kgrid, (n, 4, 5, 2)),
        "occluders": _jax_occluder_draws(kocc, n, s, h, w) if occluders else [],
        "gain": _u(kbr, (n, 1, 1, 1)),
        "offset": _u(jax.random.fold_in(kbr, 1), (n, 1, 1, 1)),
    }


def _scene_pool(s, h, w):
    return ttrain.make_scene_pool(s, h, w, seed=3, kinds=("checker", "perlin"))


@pytest.mark.parametrize("blur,occluders", [(True, True), (False, False), (True, False), (False, True)])
def test_batch_from_draws_matches_jax_sample_batch(blur, occluders):
    n, s, h, w, max_disp = 6, 4, 48, 64, 12.0
    scenes = _scene_pool(s, h, w)
    key = jax.random.PRNGKey(11)
    want = jtrain._sample_batch(key, jnp.asarray(scenes), n, max_disp, blur=blur, occluders=occluders)
    draws = _jax_sample_draws(key, n, s, h, w, occluders)
    got = ttrain._batch_from_draws(_t(scenes), draws, max_disp, blur=blur)
    for k in ("im1", "im2", "flow"):
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        _close(got[k], want[k], 1e-4)
    if occluders:  # some occluder is on and moves pixels
        plain = ttrain._batch_from_draws(_t(scenes), {**draws, "occluders": []}, max_disp, blur=blur)
        assert float((plain["flow"] - got["flow"]).abs().max()) > 1.0


def test_add_occluders_matches_jax():
    n, s, h, w, max_disp = 5, 4, 40, 56, 10.0
    rng = np.random.default_rng(6)
    scenes = _scene_pool(s, h, w)
    im1, im2 = _rand(rng, (n, h, w, 3), 0, 1), _rand(rng, (n, h, w, 3), 0, 1)
    flow = _rand(rng, (n, h, w, 2), -5, 5)
    key = jax.random.PRNGKey(7)
    want = jtrain._add_occluders(
        key, jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(flow), jnp.asarray(scenes), max_disp)
    got = ttrain._add_occluders(
        _jax_occluder_draws(key, n, s, h, w), _t(im1), _t(im2), _t(flow), _t(scenes), max_disp)
    for g, wv in zip(got, want):
        _close(g, wv, 1e-4)


def test_synthetic_from_draws_matches_jax_synthetic_batch():
    n, h, w, max_disp = 3, 48, 64, 8.0
    key = jax.random.PRNGKey(5)
    want = jtrain.synthetic_batch(key, n, h, w, max_disp)
    k1, k2, _ = jax.random.split(key, 3)
    draws = {
        "scene_seeds": torch.tensor(
            [int(jax.random.randint(jax.random.fold_in(k1, i), (), 0, 2**31 - 1)) for i in range(n)]),
        "coarse": _u(k2, (n, 4, 5, 2)),
    }
    got = ttrain._synthetic_from_draws(draws, h, w, max_disp)
    for k in ("im1", "im2", "flow"):
        _close(got[k], want[k], 1e-4)


def test_draws_have_the_shapes_and_ranges_of_the_jax_draws():
    gen = torch.Generator().manual_seed(0)
    n, s, h, w = 64, 5, 48, 64
    got = ttrain._draw_sample(gen, s, n, (h, w))
    want = _jax_sample_draws(jax.random.PRNGKey(0), n, s, h, w, True)
    assert set(got) == set(want) and len(got["occluders"]) == len(want["occluders"]) == 3
    ranges = {"idx": (0, s - 1), "blur": (0, 7), "angle": (-1, 1), "coarse": (-1, 1), "gain": (-1, 1)}
    for k, (lo, hi) in ranges.items():
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        assert lo <= float(got[k].min()) and float(got[k].max()) <= hi
    for a, b in zip(got["occluders"], want["occluders"]):
        assert {k: (v.shape, v.dtype) for k, v in a.items()} == {k: (v.shape, v.dtype) for k, v in b.items()}
        assert 0.15 * h <= float(a["cy"].min()) and float(a["cy"].max()) <= 0.85 * h
        assert w / 7.0 <= float(a["rx"].min()) and float(a["rx"].max()) <= w / 3.5
    again = ttrain._draw_sample(torch.Generator().manual_seed(0), s, n, (h, w))
    assert torch.equal(again["coarse"], got["coarse"]) and torch.equal(again["occluders"][2]["on"], got["occluders"][2]["on"])
    b = ttrain.synthetic_batch(torch.Generator().manual_seed(1), 2, 64, 64)
    assert b["im1"].shape == b["im2"].shape == (2, 64, 64, 3) and b["flow"].shape == (2, 64, 64, 2)
    assert bool(torch.isfinite(b["flow"]).all())


# ---------------------------------------------------------------------------
# Loss and gradients of the network
# ---------------------------------------------------------------------------


def _pair_batch(rng, n, h, w, max_disp):
    """A labeled pair from numpy: a smooth random scene warped by a smooth flow."""
    im1 = np.stack([ttrain.make_scene_pool(1, h, w, seed=int(rng.integers(1 << 30)), kinds=("checker",))[0]
                    for _ in range(n)])
    flow = ttrain._resize_cubic(_t(_rand(rng, (n, 4, 5, 2), -max_disp, max_disp)), (h, w))
    im2 = bilinear_warp_plain(_t(im1), flow)
    return {"im1": im1, "im2": im2.numpy(), "flow": flow.numpy()}


def _jax_loss_and_grads(cfg_kw, params, batch, mode):
    cfg = jcfg.FlowConfig(**cfg_kw)
    net = PWCNetRef(cfg)

    def loss_fn(p, b):
        pyr = net.apply(p, b["im1"], b["im2"])["flow_pyramid"]
        if mode == "supervised":
            return jtrain.multiscale_epe(pyr, b["flow"])
        return jtrain.photometric_loss(b["im1"], b["im2"], pyr, cfg)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), aux, jax.tree_util.tree_map(np.asarray, grads)


def _torch_loss_and_grads(cfg_kw, params, batch, mode):
    net = build_net(params_from_jax(jax.tree_util.tree_map(np.asarray, params)), tcfg.FlowConfig(**cfg_kw))
    loss, aux = ttrain.make_loss(net, mode)({k: _t(v) for k, v in batch.items()})
    loss.backward()
    grads = params_to_jax({k: p.grad for k, p in net.named_parameters()})
    return float(loss.detach()), aux, grads


def _assert_grads_close(got, want, rel=1e-3):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=rel * scale, err_msg=k)


@pytest.mark.parametrize("mode", ["supervised", "photometric"])
def test_tiny_net_loss_and_gradients_match_jax(mode):
    rng = np.random.default_rng(8)
    params = init_params_ref(jax.random.PRNGKey(0), jcfg.FlowConfig(**_TINY))
    batch = _pair_batch(rng, 2, 64, 64, 3.0)
    want_loss, want_aux, want = _jax_loss_and_grads(_TINY, params, batch, mode)
    got_loss, got_aux, got = _torch_loss_and_grads(_TINY, params, batch, mode)
    assert abs(got_loss - want_loss) <= 1e-3 * abs(want_loss)
    for k, v in want_aux.items():
        assert abs(float(got_aux[k]) - float(v)) <= 1e-3 * abs(float(v)), k
    _assert_grads_close(got, want)


def test_full_width_net_loss_and_gradients_match_jax():
    """The default FlowConfig (pyramid 16..196, r=4), the trained weights, one
    pair of 64x64."""
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map(jnp.asarray, load_params(CKPT))
    batch = _pair_batch(rng, 1, 64, 64, 4.0)
    want_loss, _, want = _jax_loss_and_grads(_FULL, params, batch, "supervised")
    got_loss, _, got = _torch_loss_and_grads(_FULL, params, batch, "supervised")
    assert abs(got_loss - want_loss) <= 1e-3 * abs(want_loss)
    _assert_grads_close(got, want)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps,alpha", [(40, 0.02), (1000, 0.05)])
def test_cosine_schedule_matches_optax(steps, alpha):
    sched = optax.cosine_decay_schedule(2e-4, steps, alpha=alpha)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = ttrain.make_optimizer([p], 2e-4)
    sch = ttrain.cosine_schedule(opt, steps, alpha)
    for s in range(steps + 3):
        assert abs(opt.param_groups[0]["lr"] - float(sched(s))) <= 1e-5 * 2e-4, s
        p.grad = torch.ones(3)
        opt.step()
        sch.step()


@pytest.mark.parametrize("grad_scale", [0.01, 30.0])
def test_three_optimizer_steps_match_optax(grad_scale):
    """Same parameters, the same gradients: below the clip (scale 0.01, the
    global norm under 1) and far above it (scale 30)."""
    rng = np.random.default_rng(10)
    shapes = {"a": (16, 8, 3, 3), "b": (16,), "c": (4, 4)}
    p0 = {k: _rand(rng, s, -0.3, 0.3) for k, s in shapes.items()}
    grads = [{k: _rand(rng, s) * grad_scale for k, s in shapes.items()} for _ in range(3)]

    tx = jtrain.make_optimizer(optax.cosine_decay_schedule(1e-3, 3, alpha=0.02))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(_t(v).clone()) for k, v in p0.items()}
    opt = ttrain.make_optimizer(tp.values(), 1e-3)
    sch = ttrain.cosine_schedule(opt, 3, alpha=0.02)
    for g in grads:
        for k, v in g.items():
            tp[k].grad = _t(v).clone()
        opt.step()
        sch.step()
        want_norm = float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
        assert abs(float(opt.grad_norm) - want_norm) <= 1e-5 * want_norm
    for k in shapes:
        assert np.abs(tp[k].detach().numpy() - p0[k]).max() > 1e-4  # it moved
        _close(tp[k].detach(), jp[k], 1e-5)


def test_three_train_steps_match_jax():
    """The whole step, three times on one batch: loss, grad_norm and the
    parameters after the third step."""
    rng = np.random.default_rng(12)
    cfg_j = jcfg.FlowConfig(**_TINY)
    params = init_params_ref(jax.random.PRNGKey(1), cfg_j)
    batch = _pair_batch(rng, 2, 64, 64, 3.0)
    tx = jtrain.make_optimizer(optax.cosine_decay_schedule(3e-4, 3, alpha=0.02))
    step_j = jtrain.make_train_step(cfg_j, tx, mode="supervised")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    net = build_net(params_from_jax(jax.tree_util.tree_map(np.asarray, params)), tcfg.FlowConfig(**_TINY))
    opt = ttrain.make_optimizer(net.parameters(), 3e-4)
    step_t = ttrain.make_train_step(net, opt, "supervised", ttrain.cosine_schedule(opt, 3, alpha=0.02))
    tb = {k: _t(v) for k, v in batch.items()}

    state = tx.init(params)
    for _ in range(3):
        params, state, mj = step_j(params, state, jb)
        mt = step_t(tb)
        assert set(mt) == set(mj) == {"loss", "grad_norm", "epe_finest"}
        for k in mj:
            assert abs(float(mt[k]) - float(mj[k])) <= 1e-3 * abs(float(mj[k])), k
    got = dict(_leaves(params_to_jax({k: v for k, v in net.state_dict().items()})))
    for k, w in _leaves(jax.tree_util.tree_map(np.asarray, params)):
        # Adam's first steps move every weight by about lr whatever its
        # gradient's size, so rounding noise in a near-zero gradient shows:
        # a tenth of the three steps' travel.
        _close(got[k], w, 1e-4)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["supervised", "photometric"])
def test_overfit_descends(mode):
    """Steps on one fixed batch reduce the loss, as tests/flow/test_train.py
    asks of the JAX trainer."""
    cfg = tcfg.FlowConfig(**_TINY)
    net = build_net(init_params(0, cfg, "cpu"), cfg)
    opt = ttrain.make_optimizer(net.parameters(), lr=3e-4)
    step = ttrain.make_train_step(net, opt, mode)
    disp = 3.0 if mode == "supervised" else 2.0
    batch = ttrain.synthetic_batch(torch.Generator().manual_seed(1), 2, 64, 64, max_disp=disp)
    if mode == "photometric":
        batch = {"im1": batch["im1"], "im2": batch["im2"]}
    losses = [float(step(batch)["loss"]) for _ in range(10 if mode == "supervised" else 6)]
    assert np.isfinite(losses).all() and np.isfinite(float(opt.grad_norm))
    assert losses[-1] < losses[0] if mode == "supervised" else losses[-1] <= losses[0] * 1.05


def test_train_fast_runs_saves_and_reloads(tmp_path, capsys):
    cfg = tcfg.FlowConfig(**_TINY)
    params = ttrain.train_fast(
        cfg, steps=5, batch_size=2, hw=(64, 64), scan_len=2, n_scenes=4, max_disp=4.0,
        ckpt_dir=str(tmp_path), device="cpu",
    )
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert [l.split(":")[0] for l in lines] == ["step 2/5", "step 4/5", "step 5/5"]
    history = [ast.literal_eval(l.split(": ", 1)[1]) for l in lines]  # each line ends in the chunk's means
    assert len(history) == 3 and set(history[0]) == {"loss", "grad_norm", "epe_finest"}
    assert all(np.isfinite(list(m.values())).all() for m in history)
    # the checkpoint loads in the port and in the JAX package with equal leaves
    path = os.path.join(str(tmp_path), "flow_000005.msgpack")
    back = params_from_jax(load_params(path))
    assert set(back) == set(params) and all(torch.equal(back[k], params[k]) for k in params)
    from vstab.utils.checkpoint import load_params as load_params_ref

    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, load_params_ref(path))))
    mine = dict(_leaves(params_to_jax(params)))
    assert set(ref) == set(mine) and all(np.array_equal(ref[k], mine[k]) for k in mine)
    # and a warm start from it runs
    again = ttrain.train_fast(cfg, steps=1, batch_size=2, hw=(64, 64), scan_len=1, n_scenes=2,
                              params=back, ckpt_dir=None, device="cpu")
    assert set(again) == set(params) and not torch.equal(again["context.dconv0.weight"], back["context.dconv0.weight"])
    assert torch.equal(back["context.dconv0.weight"], params["context.dconv0.weight"])  # the caller's stay


def test_train_and_main_run_on_the_cpu(tmp_path, capsys):
    cfg = tcfg.FlowConfig(**_TINY)
    p = ttrain.train(cfg, steps=2, batch_size=1, hw=(64, 64), log_every=1, ckpt_dir=str(tmp_path),
                     mode="photometric", device="cpu")
    out = capsys.readouterr().out
    assert "step 0:" in out and "step 1:" in out and "'photo'" in out
    assert os.path.exists(os.path.join(str(tmp_path), "flow_000002.msgpack")) and len(p) == 42
    with pytest.raises(RuntimeError):
        if torch.cuda.is_available():
            raise RuntimeError("a card is present: the default device would run")
        ttrain.train(cfg, steps=1, ckpt_dir=None)  # no card and no device="cpu": raises


def test_eval_epe_of_the_trained_net_is_close_to_the_jax_package():
    """`flow_086000` on 8 held-out pairs of the checker family, each package
    on its own draws: the port's EPE under 1.5x the JAX package's."""
    tree = load_params(CKPT)
    hw = (128, 192)
    got = ttrain.eval_epe(params_from_jax(tree), tcfg.FlowConfig(**_FULL), hw=hw, n=8, kinds=("checker",), device="cpu")
    want = jtrain.eval_epe(jax.tree_util.tree_map(jnp.asarray, tree), jcfg.FlowConfig(**_FULL), hw=hw, n=8,
                           kinds=("checker",))
    assert 0.0 < got < 1.5 * want, (got, want)
    assert got < 2.0  # px: the trained net, not a random one
