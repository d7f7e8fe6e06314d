"""vstab_torch flow network and checkpoint reader held against the JAX
package on the CPU, in f32.

Tolerances: 1e-5 for single layers, 1e-4 px for the tiny random-init net
(the config of `__graft_entry__._tiny_flow_cfg`), 2e-3 px for the trained
`flow_086000` net at 2 pairs of 64x128 (six levels of convs and warps
accumulate f32 rounding in another order).
"""

import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import vstab.core.config as jcfg
from vstab.flow.pwcnet import (
    estimate_flow as estimate_flow_ref,
    estimate_flow_pairs as estimate_flow_pairs_ref,
    init_params,
    pad_to_multiple as pad_to_multiple_ref,
)
from vstab_torch.core import config as tcfg
from vstab_torch.flow.layers import Conv, ConvTranspose
from vstab_torch.flow.pwcnet import (
    PWCNet,
    estimate_flow,
    estimate_flow_pairs,
    pad_to_multiple,
)
from vstab_torch.pipeline import _params_match
from vstab_torch.utils.checkpoint import (
    latest_checkpoint,
    load_params,
    params_from_jax,
    params_to_jax,
    save_params,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "ckpts", "flow_086000.msgpack")


def _tiny(mod):
    # __graft_entry__._tiny_flow_cfg("xla")
    return mod.FlowConfig(
        pyramid_channels=(8, 16, 24),
        estimator_channels=(16, 16),
        context_dilations=(1, 2, 1),
        search_radius=2,
        kernel_impl="xla",
        compute_dtype="float32",
        output_level=2,
    )


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_load_params_equals_flax_msgpack_restore():
    got = dict(_leaves(load_params(CKPT)))
    with open(CKPT, "rb") as f:
        want = dict(_leaves(serialization.msgpack_restore(f.read())))
    assert len(want) == 126 and set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    assert sum(v.size for v in got.values()) == 10_176_650


def test_params_to_jax_is_the_inverse_of_params_from_jax_bit_for_bit():
    tree = load_params(CKPT)
    back = params_to_jax(params_from_jax(tree))
    want, got = dict(_leaves(tree)), dict(_leaves(back))
    assert list(got) == list(want)  # the same leaves in the same order
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and got[k].flags.c_contiguous, k
        np.testing.assert_array_equal(got[k], v)
    again = params_from_jax(back)
    sd = params_from_jax(tree)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_save_params_writes_what_flax_writes_and_the_jax_package_loads_it(tmp_path):
    from vstab.utils.checkpoint import load_params as load_params_ref

    tree = load_params(CKPT)
    path = str(tmp_path / "sub" / "flow_000001.msgpack")
    save_params(path, params_to_jax(params_from_jax(tree)))
    with open(path, "rb") as f, open(CKPT, "rb") as g:
        data = f.read()
        assert data == g.read()  # the committed checkpoint, byte for byte
    assert data == serialization.to_bytes(tree)
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, load_params_ref(path))))
    for k, v in _leaves(tree):
        np.testing.assert_array_equal(ref[k], v)


@pytest.mark.parametrize("shape", [(), (1,), (3, 0, 2), (300, 70), (17,) * 1 + (2,) * 15])
def test_save_params_round_trips_odd_shapes_like_flax(tmp_path, shape):
    """Header forms the trained checkpoint does not reach: fixext payloads,
    16- and 32-bit lengths, a 16-dimensional shape, an empty array, more
    than 15 keys in a map."""
    rng = np.random.default_rng(0)
    arr = rng.normal(size=shape).astype(np.float32)
    tree = {"params": {"m": {f"layer{i}": {"kernel": arr, "bias": np.float32(i) * np.ones(2, np.float32)}
                             for i in range(17)}}}
    path = str(tmp_path / "x.msgpack")
    save_params(path, tree)
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(tree)
    back = dict(_leaves(load_params(path)))
    for k, v in _leaves(tree):
        np.testing.assert_array_equal(back[k], v)


def test_latest_checkpoint_orders_by_step(tmp_path):
    for name in ("flow_000900.msgpack", "flow_010000.msgpack", "flow_002000.msgpack"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)).endswith("flow_010000.msgpack")
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_config_json_from_reference_loads():
    for name in ("affine_480p", "full_720p", "blocked_1080p", "dp_sweep", "multihost_4k"):
        ref = jcfg.preset(name)
        port = tcfg.Config.from_json(ref.to_json())
        assert port == tcfg.preset(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("stride,dilation,size", [(2, 1, (8, 12)), (2, 1, (7, 9)), (1, 2, (8, 12))])
def test_conv_matches_flax(stride, dilation, size):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *size, 5)).astype(np.float32)
    mod = fnn.Conv(6, (3, 3), strides=(stride, stride), kernel_dilation=(dilation, dilation))
    p = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = mod.apply(p, jnp.asarray(x))
    conv = Conv(5, 6, stride=stride, dilation=dilation, dtype=torch.float32)
    sd = params_from_jax({"params": {"m": {"c": jax.tree_util.tree_map(np.asarray, p["params"])}}})
    conv.load_state_dict({"weight": sd["m.c.weight"], "bias": sd["m.c.bias"]})
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_conv_transpose_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    mod = fnn.ConvTranspose(2, (4, 4), strides=(2, 2))
    p = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = mod.apply(p, jnp.asarray(x))
    sd = params_from_jax({"params": {"up1": {"upflow": jax.tree_util.tree_map(np.asarray, p["params"])}}})
    conv = ConvTranspose(3, 2, dtype=torch.float32)
    conv.load_state_dict({"weight": sd["up1.upflow.weight"], "bias": sd["up1.upflow.bias"]})
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    assert got.shape == (2, 10, 14, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_pad_to_multiple_matches_reference():
    x = np.random.default_rng(2).random((2, 37, 50, 3)).astype(np.float32)
    want, wp = pad_to_multiple_ref(jnp.asarray(x), 16)
    got, gp = pad_to_multiple(torch.from_numpy(x), 16)
    assert gp == wp
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tiny():
    jp = init_params(jax.random.PRNGKey(0), _tiny(jcfg))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp


def test_tiny_params_convert_to_port_layout(tiny):
    _, tp = tiny
    assert _params_match(tp, _tiny(tcfg))
    assert not _params_match(tp, tcfg.FlowConfig(compute_dtype="float32"))


def test_tiny_net_pair_flow_matches_reference(tiny):
    jp, tp = tiny
    frames = np.random.default_rng(3).random((4, 40, 56, 3)).astype(np.float32)
    want = estimate_flow_pairs_ref(jp, jnp.asarray(frames), _tiny(jcfg))
    got = estimate_flow_pairs(tp, torch.from_numpy(frames), _tiny(tcfg))
    assert got.shape == (3, 40, 56, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # the unshared path gives the same flow
    one = estimate_flow(tp, torch.from_numpy(frames[:-1]), torch.from_numpy(frames[1:]), _tiny(tcfg))
    np.testing.assert_allclose(one.numpy(), got.numpy(), rtol=0, atol=1e-5)
    ref_one = estimate_flow_ref(jp, jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]), _tiny(jcfg))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref_one), rtol=0, atol=1e-4)


def test_trained_net_matches_reference():
    from vstab.utils.checkpoint import load_params as load_params_ref

    cfg_j = jcfg.FlowConfig(kernel_impl="xla", compute_dtype="float32")
    cfg_t = tcfg.FlowConfig(kernel_impl="xla", compute_dtype="float32")
    rng = np.random.default_rng(4)
    base = rng.random((80, 150, 3)).astype(np.float32)
    frames = np.stack([base[8:72, 8:136], base[6:70, 11:139], base[9:73, 13:141]])
    want = estimate_flow_pairs_ref(load_params_ref(CKPT), jnp.asarray(frames), cfg_j)
    tp = params_from_jax(load_params(CKPT))
    assert _params_match(tp, cfg_t)
    got = estimate_flow_pairs(tp, torch.from_numpy(frames), cfg_t)
    assert got.shape == (2, 64, 128, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)


def test_fresh_net_runs_in_bf16_on_cpu():
    cfg = dataclasses.replace(_tiny(tcfg), compute_dtype="bfloat16")
    net = PWCNet(cfg)
    frames = torch.rand((2, 32, 32, 3))
    with torch.no_grad():
        out = net(frames[:1], frames[1:])
    assert out["flow"].dtype == torch.float32 and out["flow"].shape == (1, 32, 32, 2)
    assert torch.isfinite(out["flow"]).all()
