"""The reference against the port's CPU path at tiny sizes, in float32: the
two are written apart and must agree to rounding."""

import json
import os

import pytest
import torch

from h100bench import harness, judge, weights
from h100bench.reference import precision, pwcnet, warps
from h100bench.reference import stabilize as ref
from h100bench.tests import helpers

torch.set_num_threads(4)


def _cfg(name="pwcnet_stabilize", **flow):
    with open(os.path.join(harness.ROOT, f"h100bench/configs/{name}.json")) as f:
        cfg = json.load(f)["program"]
    cfg["flow"].update(flow)
    return cfg


def _program_config(cfg):
    from vstab_torch.core.config import Config

    return Config.from_json(json.dumps(cfg))


def test_plain_operations_match_the_ports():
    from vstab_torch.kernels import bilinear_warp_plain, cost_volume_plain, warp_twopass

    g = torch.Generator().manual_seed(0)
    f1, f2 = torch.randn(2, 9, 11, 8, generator=g), torch.randn(2, 9, 11, 8, generator=g)
    assert torch.allclose(warps.cost_volume(f1, f2, 4), cost_volume_plain(f1, f2, 4))
    flow = 3.0 * torch.randn(2, 9, 11, 2, generator=g)
    assert torch.allclose(warps.bilinear_warp(f1, flow), bilinear_warp_plain(f1, flow))
    assert torch.allclose(warps.bilinear_warp(f1, flow, 8), bilinear_warp_plain(f1, flow.clamp(-8, 8)))
    frames = torch.rand(2, 20, 30, 3, generator=g)
    smooth = torch.nn.functional.interpolate(4.0 * torch.randn(2, 2, 3, 4, generator=g),
                                             size=(20, 30), mode="bilinear").permute(0, 2, 3, 1)
    for d in (16, 127):
        assert torch.allclose(warps.warp_twopass(frames, smooth, d), warp_twopass(frames, smooth, d),
                              atol=1e-6)


def test_flow_net_matches_the_port_in_float32():
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow.pwcnet import estimate_flow_pairs

    cfg = _cfg(compute_dtype="float32")
    params = weights.load(os.path.join(harness.ROOT, "ckpts/flow_086000.msgpack"), "cpu")
    frames = harness.generator("shaky_clips").clip(torch.Generator().manual_seed(1), 3, 64, 96)
    fc = FlowConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["flow"].items()})
    port = estimate_flow_pairs(params, frames, fc)
    ours = torch.cat(list(pwcnet.pair_flow_blocks(params, frames, cfg["flow"], "f32")))
    assert port.shape == ours.shape == (2, 64, 96, 2)
    assert float((port - ours).abs().max()) < 1e-3
    assert float(ours.abs().max()) > 1.0  # a real motion, not zeros


def test_stabilizer_matches_the_port_in_float32():
    import vstab_torch

    cell, params = helpers.tiny_cell("stab_720p_whole", tiny_net=True, frames=12)
    cfg = cell.config["program"]
    cfg["flow"]["compute_dtype"] = "float32"
    frames = harness.generator("shaky_clips").clip(torch.Generator().manual_seed(2), 12, 64, 96)
    out, diags = vstab_torch.stabilize(frames, params, _program_config(cfg), device="cpu")
    with precision.tf32(False):
        solved = ref.solve(frames, params, cfg)
        disp = diags["profiles"] - diags["smoothed"]
        assert float((diags["profiles"] - solved["profiles"]).abs().max()) < 1e-4
        assert float((disp - solved["disp"]).abs().max()) < 1e-3
        ours = torch.cat([b for _, b in ref.render_blocks(frames, solved, cfg, "cpu", block=5)])
    assert float((out - ours).abs().mean()) < 1e-5


def test_trainer_matches_the_port_in_float32():
    from h100bench.drivers import common
    from h100bench.drivers import train as drv
    from h100bench.reference import train as ref_train

    cell, params = helpers.tiny_cell("train_192x256_b8", tiny_net=True)
    recipe, cfg = cell.config["recipe"], common.program_config(cell.config)
    scenes = harness.generator("scene_pool").generate(cell.traffic, 5, "cpu")["scenes"]
    gen = torch.Generator().manual_seed(9)
    net, opt, step = drv.build_step(params, cfg, recipe, torch.device("cpu"))
    first = drv.first_steps(step, net, opt, gen, scenes, recipe, 3)
    ours = ref_train.run(params, scenes, 9, cell.config["program"]["flow"], recipe, 3)
    r = judge.trainer_readings(first, ours, params)
    assert r["batch_max"] < 1e-5 and r["loss_rel"] < 1e-5
    grad, update = judge.leaf_gaps(first, ours, params)
    assert max(grad.values()) < 1e-4 and max(update.values()) < 1e-4, (grad, update)


@pytest.mark.parametrize("policy", ["fp8", "tf32"])
def test_the_controls_round_what_they_say(policy):
    x = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    y = precision.lowp(policy, x)
    big = x.abs() >= 0.1 * x.abs().max()  # normal numbers under fp8's per-tensor scale
    rel = float(((y - x).abs() / x.abs())[big].max())
    assert 0 < rel <= (2**-4 if policy == "fp8" else 2**-11)
    assert torch.equal(precision.lowp("f32", x), x)
    assert torch.equal(precision.lowp("fp8", x, stated_bf16=False), x)
