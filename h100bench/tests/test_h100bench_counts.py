"""The yardstick's counts against hand computations and against the
convolutions the port runs."""

import json
import os

import pytest
import torch

from h100bench import harness
from h100bench.counts import HBM_BYTES_PER_S, PEAK_FLOPS
from h100bench.counts import kernels as kc
from h100bench.counts import pwcnet as pc

with open(os.path.join(harness.ROOT, "h100bench/configs/pwcnet_stabilize.json")) as f:
    FLOW = json.load(f)["program"]["flow"]
SMALL = {"pyramid_channels": [2, 3], "search_radius": 1, "estimator_channels": [4],
         "context_dilations": [1], "output_level": 1, "warp_max_disp": 8,
         "compute_dtype": "float32", "kernel_impl": "auto"}


def test_small_network_by_hand():
    # frames of 4x4 (padded to a multiple of 4): level 1 is 2x2, level 2 is 1x1.
    pyr = 2 * 3 * 2 * 9 * 4 + 2 * (2 * 2 * 2 * 9 * 4) + 2 * 2 * 3 * 9 * 1 + 2 * (2 * 3 * 3 * 9 * 1)
    assert pc.pyramid_flops(4, 4, SMALL) == pyr
    cv = 2 * 9 * 3 * 1 + 2 * 9 * 2 * 4
    assert pc.cost_volume_flops(4, 4, SMALL) == cv
    coarse = 2 * 12 * 4 * 9 * 1 + 2 * 16 * 2 * 9 * 1  # conv0 (9+3 -> 4), predict (16 -> 2)
    up = 2 * 16 * 1 * 1 * (2 * 2 + 16 * 2)  # upflow 2 -> 2 and upfeat 16 -> 2 from 1x1
    fine = 2 * 15 * 4 * 9 * 4 + 2 * 19 * 2 * 9 * 4  # conv0 (9+2+4 -> 4), predict (19 -> 2)
    ctx = 2 * 21 * 128 * 9 * 4 + 2 * 128 * 2 * 9 * 4  # dconv0 (19+2 -> 128), predict_res
    assert pc.pair_conv_flops(4, 4, SMALL) == coarse + up + fine + ctx
    assert pc.clip_flops(3, 4, 4, SMALL) == 3 * pyr + 2 * (cv + coarse + up + fine + ctx)
    assert pc.train_step_flops(2, 4, 4, SMALL) == 3 * 2 * (2 * pyr + cv + coarse + up + fine + ctx)


@pytest.mark.parametrize("hw", [(64, 64), (80, 130)])
def test_convolutions_match_a_forward_hook_count_on_the_port(hw):
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow.layers import Conv, ConvTranspose
    from vstab_torch.flow.pwcnet import PWCNet, pad_to_multiple

    cfg = FlowConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in FLOW.items()})
    cfg = FlowConfig(**{**cfg.__dict__, "compute_dtype": "float32"})
    torch.manual_seed(0)
    net = PWCNet(cfg).eval()
    counted = []

    def hook(mod, inp, out):
        cout, cin = (mod.weight.shape[0], mod.weight.shape[1]) if isinstance(mod, Conv) else (
            mod.weight.shape[1], mod.weight.shape[0])
        if isinstance(mod, Conv):
            k = mod.weight.shape[-1]
            counted.append(2.0 * cin * cout * k * k * out.shape[0] * out.shape[1] * out.shape[2])
        else:
            x = inp[0]
            counted.append(2.0 * cin * cout * 16 * x.shape[0] * x.shape[1] * x.shape[2])

    for m in net.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            m.register_forward_hook(hook)
    im = pad_to_multiple(torch.rand(1, *hw, 3), 64)[0]
    with torch.no_grad():
        net(im, im)
    want = 2 * pc.pyramid_flops(*hw, FLOW) + pc.pair_conv_flops(*hw, FLOW)
    assert sum(counted) == pytest.approx(want, rel=1e-12)


def test_published_sizes():
    assert pc.clip_flops(48, 720, 1280, FLOW) == pytest.approx(16.493e12, rel=1e-4)
    assert pc.clip_flops(48, 720, 1280, FLOW) / pc.clip_flops(48, 256, 320, FLOW) == pytest.approx(12.0)
    assert pc.train_step_flops(8, 192, 256, FLOW) == pytest.approx(434.09e9, rel=1e-4)


def test_kernel_bytes_and_operations_by_hand():
    # cost volume, f32, 1x2x3 pixels, 4 channels, r = 1: f1, f2 read, 9 outputs written
    assert kc.launch_cost("vstab_cost_volume", [0, 0, 0, 1, 2, 3, 4, 1, 0, 0]) == (
        6 * (2 * 4 + 9) * 4, 2.0 * 9 * 4 * 6, "float32")
    # bf16 halves the bytes
    assert kc.launch_cost("vstab_cost_volume", [0, 0, 0, 1, 2, 3, 4, 1, 1, 0])[0] == 6 * 17 * 2
    # its backward with both gradients: g read, both maps read, both gradients written
    assert kc.launch_cost("vstab_cost_volume_bwd", [0, 0, 0, 1, 1, 1, 2, 3, 4, 1, 0, 0]) == (
        6 * (9 + 4 * 4) * 4, 2 * 2.0 * 9 * 4 * 6, "float32")
    assert kc.launch_cost("vstab_cost_volume_bwd", [0, 0, 0, 1, None, 1, 2, 3, 4, 1, 0, 0])[0] == (
        6 * (9 + 2 * 4) * 4)
    # feature warp: image read, flow read, image written
    assert kc.launch_cost("vstab_bilinear_warp", [0, 0, 0, 2, 3, 4, 8, 8.0, 1, 0, 0])[0] == (
        24 * (2 * 8 * 2 + 2 * 4))
    # its backward, dimg and dflow: g, flow, image read; dimg, dflow written
    assert kc.launch_cost("vstab_bilinear_warp_bwd",
                          [0, 0, 0, 1, 1, 1, 2, 2, 4, 8.0, 0, 0, 0])[0] == 4 * (3 * 4 * 4 + 4 * 4)
    # 1-D warps: frame and field read, frame written
    assert kc.launch_cost("vstab_vwarp", [0, 0, 0, 2, 3, 5, 3, 16.0, 0, 0])[0] == 30 * 7 * 4
    with pytest.raises(KeyError):
        kc.launch_cost("vstab_unknown", [])


def test_bound_is_the_larger_of_bytes_and_operations():
    args = [0, 0, 0, 8, 192, 320, 32, 4, 1, 0]  # the 720p finest level, bf16
    nbytes, ops, _ = kc.launch_cost("vstab_cost_volume", args)
    assert kc.bound_s("vstab_cost_volume", args) == max(
        nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["bfloat16"])
    assert kc.bound_s("vstab_cost_volume", args) * 1e3 == pytest.approx(0.0425, abs=1e-4)
