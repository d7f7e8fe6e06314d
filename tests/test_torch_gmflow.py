"""vstab_torch's GMFlow held against the plain GMFlow of the benchmark's
reference, `h100bench/reference/gmflow.py` (plain float32 torch following
the published code, importing nothing of `vstab_torch`), on the CPU, at the
published widths on 64x96 frames and on 72x100 (padded to 96x128), with
seeded weights (the JAX package has no GMFlow).

Weights: GMFlow's initialisers drawn from a seed, then the layer norms'
gains scaled by 0.1 and the trident weight (both scales' features) by 0.15,
as the benchmark's configuration draws them (`reference.gmflow.init_params(
norm_gain=0.1, feature_scale=0.15)`). With the initialisers as published
the seeded network is chaotic: its global softmaxes pick among near ties,
so float32 rounding alone moves the flow by up to 0.4 px and bfloat16 by a
mean of 6 to 12 px on these frames, and no tolerance would say anything.

Tolerances, each with its reason:
- a stage in float32 (backbone, transformer block, position): 2e-4 abs on
  features of magnitude ~20. The two compute the same operations in
  float32; the port keeps channels-last memory, fuses the attention and
  sums in other orders (observed under 1e-4).
- matchings, propagations, upsampling, warp in float32: 1e-4 px (observed
  under 8e-5).
- the whole flow in float32: 1e-4 px (observed 1e-5).
- the whole flow in bfloat16 (the configuration's precision): the port
  rounds the backbone's, the transformer's and the upsampler's activations
  and weights to 8 mantissa bits and the reference does not; the mean gap
  stays under 5% of the mean flow (observed 0.7 to 3.2% on flows of 1.0 to
  2.6 px, three seeds at each size); the fp8 control (the reference with its
  bfloat16 operands rounded to e4m3) reads 5.8 to 15%.
- stabilize: the same render bucket, and output within 1e-3 of the output
  rendered from the reference's flow on at least 99.9% of the values, as
  `tests/test_torch_raft.py` holds RAFT's.
"""

import math

import pytest
import torch
import torch.nn.functional as F

import vstab.core.config as jcfg
from h100bench.reference import gmflow as ref
import vstab_torch
from vstab_torch.core import config as tcfg
from vstab_torch.core.config import Config, GmflowConfig
from vstab_torch.flow import gmflow, raft
from vstab_torch.pipeline import clip_flow, default_params, stabilize_from_flow
from vstab_torch.utils import trace

torch.set_num_threads(1)
F32 = GmflowConfig(compute_dtype="float32")
STAGE_ATOL, FLOW_ATOL, WHOLE_ATOL = 2e-4, 1e-4, 1e-4


@pytest.fixture(scope="module")
def params():
    return ref.init_params(0, "cpu", norm_gain=0.1, feature_scale=0.15)


def _frames(t=3, h=64, w=96, seed=1):
    return torch.rand((t, h, w, 3), generator=torch.Generator().manual_seed(seed))


def _images(frames):
    mean = torch.tensor(ref.MEAN).view(1, 3, 1, 1)
    std = torch.tensor(ref.STD).view(1, 3, 1, 1)
    return (frames.permute(0, 3, 1, 2) - mean) / std


def _ref_flow(p, frames):
    return torch.cat(list(ref.pair_flows(p, frames)))


@pytest.fixture(scope="module")
def features(params):
    """The reference's [1/8, 1/4] features of two 64x96 frames."""
    x = _images(_frames(t=2))
    return ref.backbone(params, x[:1], "f32"), ref.backbone(params, x[1:], "f32")


def test_state_dict_has_gmflows_names_and_shapes():
    p = gmflow.init_params(0, device="cpu")
    want = {
        "backbone.conv1.weight": (64, 3, 7, 7), "backbone.layer1.0.conv1.weight": (64, 64, 3, 3),
        "backbone.layer2.0.downsample.0.weight": (96, 64, 1, 1), "backbone.layer2.0.downsample.0.bias": (96,),
        "backbone.layer3.0.downsample.0.weight": (128, 96, 1, 1), "backbone.conv2.bias": (128,),
        "backbone.trident_conv.weight": (128, 128, 3, 3),
        "transformer.layers.0.self_attn.q_proj.weight": (128, 128),
        "transformer.layers.5.cross_attn_ffn.merge.weight": (128, 128),
        "transformer.layers.3.cross_attn_ffn.mlp.0.weight": (1024, 256),
        "transformer.layers.3.cross_attn_ffn.mlp.2.weight": (128, 1024),
        "transformer.layers.0.cross_attn_ffn.norm2.bias": (128,),
        "feature_flow_attn.k_proj.bias": (128,), "upsampler.0.weight": (256, 130, 3, 3),
        "upsampler.2.weight": (144, 256, 1, 1),
    }
    for k, shape in want.items():
        assert tuple(p[k].shape) == shape, k
    absent = ("backbone.conv1.bias", "backbone.layer1.0.conv1.bias", "backbone.layer1.0.downsample.0.weight",
              "backbone.trident_conv.bias", "transformer.layers.0.self_attn.mlp.0.weight",
              "transformer.layers.0.self_attn.q_proj.bias")
    assert not any(k in p for k in absent)
    assert list(p) == list(gmflow.param_shapes()) == [k for k, _ in ref.param_rows()]
    assert sum(v.numel() for v in p.values()) == 4_716_720  # GMFlow with refinement's count


def test_init_params_draws_the_references_numbers():
    a, b = gmflow.init_params(7, device="cpu"), ref.init_params(7, "cpu")
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    w = a["backbone.layer1.0.conv1.weight"]  # kaiming normal, fan_out = 64 * 9
    assert abs(float(w.std()) / (2.0 / (64 * 9)) ** 0.5 - 1.0) < 0.05
    x = a["transformer.layers.0.cross_attn_ffn.mlp.0.weight"]  # xavier uniform
    assert float(x.abs().max()) <= (6.0 / (256 + 1024)) ** 0.5
    assert torch.equal(a["transformer.layers.2.self_attn.norm1.weight"], torch.ones(128))
    c = ref.init_params(7, "cpu", norm_gain=0.1, feature_scale=0.15)
    assert torch.equal(c["transformer.layers.2.self_attn.norm1.weight"], torch.full((128,), 0.1))
    assert torch.equal(c["backbone.trident_conv.weight"], 0.15 * a["backbone.trident_conv.weight"])
    assert all(torch.equal(c[k], a[k]) for k in a if ".norm" not in k and "trident" not in k)


def test_backbone_matches_reference_at_both_scales(params):
    x = _images(_frames())
    want = ref.backbone(params, x, "f32")
    got = gmflow.backbone(gmflow.prepare(params, F32), x.contiguous(memory_format=torch.channels_last))
    assert [tuple(t.shape) for t in got] == [(3, 128, 16, 24), (3, 128, 8, 12)]
    for g, w in zip(got, want[::-1]):
        torch.testing.assert_close(g, w, rtol=0, atol=STAGE_ATOL)


@pytest.mark.parametrize("splits", [2, 8])
def test_position_matches_reference(features, splits):
    f0, f1 = features[0][splits == 8], features[1][splits == 8]
    w0, w1 = ref.feature_add_position(f0, f1, splits)
    pos = gmflow.position(*f0.shape[-2:], splits, "cpu").permute(2, 0, 1)
    assert torch.equal(w0, f0 + pos) and torch.equal(w1, f1 + pos)


@pytest.mark.parametrize("block", [0, 1])  # block 1 shifts its windows
@pytest.mark.parametrize("scale", [0, 1])
def test_transformer_block_matches_reference(params, features, block, scale):
    splits = (2, 8)[scale]
    a, b = features[0][scale], features[1][scale]
    h, w = a.shape[-2:]
    tok0, tok1 = a.flatten(2).transpose(1, 2), b.flatten(2).transpose(1, 2)
    src, tgt = torch.cat([tok0, tok1]), torch.cat([tok1, tok0])
    wh, ww = h // splits, w // splits
    mask = ref.shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2, "cpu")
    name = f"transformer.layers.{block}."
    want = ref.transformer_layer(params, name + "self_attn", src, src, h, w, splits, block == 1, mask, "f32")
    want = ref.transformer_layer(params, name + "cross_attn_ffn", want, tgt, h, w, splits, block == 1, mask,
                                 "f32")
    p = gmflow.prepare(params, F32)
    order = gmflow.window_order(h, w, splits, block == 1, "cpu")
    x = torch.cat([gmflow.tokens(a), gmflow.tokens(b)]).flatten(1, 2)[:, order]  # the block's layout
    m = gmflow.shift_mask(h, w, splits, torch.float32, "cpu") if block == 1 else None
    got = gmflow.attention_layer(p, name + "self_attn", x, x, splits, m)
    got = gmflow.attention_layer(p, name + "cross_attn_ffn", got, torch.cat([x[1:], x[:1]]), splits, m)
    torch.testing.assert_close(got[:, torch.argsort(order)], want, rtol=0, atol=STAGE_ATOL)
    if block == 1:  # the mask matters: the shifted windows without it read otherwise
        plain = gmflow.attention_layer(p, name + "self_attn", x, x, splits, None)
        assert float((plain - gmflow.attention_layer(p, name + "self_attn", x, x, splits, m)).abs().max()) > 1e-2


def test_window_order_is_swins_split_of_the_rolled_map():
    h, w, splits = 12, 16, 2
    t = torch.arange(h * w).view(1, h, w, 1)
    for shifted in (False, True):
        rolled = torch.roll(t, (-3, -4), (1, 2)) if shifted else t
        want = ref.split_feature(rolled, splits, channel_last=True).reshape(-1)
        assert torch.equal(gmflow.window_order(h, w, splits, shifted, "cpu"), want)


def test_shift_mask_is_swins():
    got = gmflow.shift_mask(12, 16, 2, torch.float32, "cpu")[0]
    want = ref.shift_window_attn_mask(12, 16, 6, 8, 3, 4, "cpu")
    assert torch.equal(got, want)
    assert got.stride(-2) % 16 == 0  # rows laid out 16-aligned for the attention kernels
    assert set(got.unique().tolist()) == {-100.0, 0.0} and not got[0].any()  # window 0 is one region


def _pattern(h, w, seed=3):
    """A random pattern of 128 channels, larger than the frame: a position's
    own logit (~45) stands far above any other's (spread ~2)."""
    return 2.0 * torch.randn((128, h + 16, w + 16), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("shift", [(3, -2), (-5, 4)])
def test_global_matching_recovers_a_translation(shift):
    """F1 is F0's pattern moved by (dx, dy): every position whose match lies
    inside the map finds it, flow = -(dx, dy)."""
    h, w = 12, 16
    big = _pattern(h, w)
    dx, dy = shift
    f0 = big[:, 8 : 8 + h, 8 : 8 + w].contiguous()
    f1 = big[:, 8 + dy : 8 + dy + h, 8 + dx : 8 + dx + w].contiguous()
    flow = gmflow.global_match(gmflow.tokens(f0[None]), gmflow.tokens(f1[None]))[0]
    inner = flow[:, max(0, dy) : h + min(0, dy), max(0, dx) : w + min(0, dx)]
    torch.testing.assert_close(inner, torch.tensor([-dx, -dy], dtype=torch.float32).view(2, 1, 1)
                               .expand_as(inner), rtol=0, atol=1e-3)
    want = ref.global_correlation_softmax(f0[None], f1[None])[0]
    torch.testing.assert_close(flow, want, rtol=0, atol=FLOW_ATOL)


def test_local_matching_masks_candidates_outside_the_map():
    """F1 is zero: every inside candidate reads the logit 0, so the flow is
    the mean of the displacements that stay inside the map (a corner
    pixel's (2, 2), not the (0, 0) an unmasked window of zeros would give)."""
    h, w, r = 7, 9, 4
    f0 = torch.randn((1, h, w, 128), generator=torch.Generator().manual_seed(2))
    flow = gmflow.local_match(f0, torch.zeros_like(f0), r)[0]
    for y in range(h):
        for x in range(w):
            dxs = [d for d in range(-r, r + 1) if 0 <= x + d < w]
            dys = [d for d in range(-r, r + 1) if 0 <= y + d < h]
            want = (sum(dxs) / len(dxs), sum(dys) / len(dys))
            assert abs(float(flow[0, y, x]) - want[0]) < 1e-5 and abs(float(flow[1, y, x]) - want[1]) < 1e-5
    f1 = torch.randn((1, h, w, 128), generator=torch.Generator().manual_seed(3))
    want = ref.local_correlation_softmax(f0.permute(0, 3, 1, 2), f1.permute(0, 3, 1, 2), r)
    torch.testing.assert_close(gmflow.local_match(f0, f1, r), want, rtol=0, atol=FLOW_ATOL)


@pytest.mark.parametrize("radius", [-1, 1])
def test_propagation_matches_reference(params, features, radius):
    f0 = features[0][radius > 0]
    flow = 4.0 * torch.randn((1, 2, *f0.shape[-2:]), generator=torch.Generator().manual_seed(5))
    want = ref.feature_flow_attention(params, f0, flow, radius)
    got = gmflow.propagate(gmflow.prepare(params, F32), gmflow.tokens(f0), flow, radius)
    torch.testing.assert_close(got, want, rtol=0, atol=FLOW_ATOL)
    assert float((got - flow).abs().mean()) > 0.1  # it moves the flow


def test_warp_samples_zeros_outside(features):
    f1 = features[1][1]
    flow = 3.0 * torch.randn((1, 2, *f1.shape[-2:]), generator=torch.Generator().manual_seed(6))
    got = gmflow.warp(gmflow.tokens(f1), flow).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, ref.flow_warp(f1, flow), rtol=0, atol=FLOW_ATOL)
    far = gmflow.warp(gmflow.tokens(f1), torch.full_like(flow, 100.0))
    assert not far.any()  # GMFlow's rule, not PWC-Net's border clamp


def test_convex_upsampling_matches_reference_and_scales_a_constant_flow_by_four(params, features):
    f0 = features[0][1]
    p = gmflow.prepare(params, F32)
    flow = 2.0 * torch.randn((1, 2, *f0.shape[-2:]), generator=torch.Generator().manual_seed(7))
    x = torch.cat([flow, f0], dim=1)
    got = raft.convex_upsample(p, "upsampler", x, flow, 4)
    assert got.shape == (1, 2, 64, 96)
    torch.testing.assert_close(got, ref.upsample_flow(params, flow, f0, "f32"), rtol=0, atol=FLOW_ATOL)
    const = torch.tensor([1.5, -0.25]).view(1, 2, 1, 1).expand_as(flow).contiguous()
    up = raft.convex_upsample(p, "upsampler", torch.cat([const, f0], dim=1), const, 4)
    inner = up[:, :, 4:-4, 4:-4]  # away from unfold's zero border
    torch.testing.assert_close(inner, 4.0 * const[:, :, :1, :1].expand_as(inner), rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 96), (72, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_matches_reference(params, hw, dtype):
    frames = _frames(h=hw[0], w=hw[1])
    want = _ref_flow(params, frames)
    cfg = GmflowConfig(compute_dtype=dtype)
    got = gmflow.estimate_flow_pairs(gmflow.prepare(params, cfg), frames, cfg)
    assert got.shape == (2, *hw, 2) and got.dtype == torch.float32
    gap = (got - want).abs()
    if dtype == "float32":
        assert float(gap.max()) < WHOLE_ATOL
    else:
        assert float(gap.mean()) < 0.05 * float(want.abs().mean())
    assert float(want.abs().mean()) > 0.5  # the flow is not trivially small


def test_stabilize_with_gmflow_matches_the_reference_flow(params):
    frames = _frames(t=9, seed=2)
    cfg = Config(flow=F32)
    out, diags = vstab_torch.stabilize(frames, params, cfg, device="cpu")
    want, _ = stabilize_from_flow(frames, _ref_flow(params, frames), cfg)
    assert out.shape == frames.shape
    close = ((out - want).abs() <= 1e-3).float().mean()
    assert float(close) >= 0.999


def test_clip_flow_chunks_gmflow_pairs_as_one_call(params):
    frames = _frames(t=4, seed=3)
    whole = gmflow.estimate_flow_pairs(gmflow.prepare(params, F32), frames, F32)
    for chunk in (1, 2):
        torch.testing.assert_close(clip_flow(params, frames, Config(flow=F32), pair_chunk=chunk), whole,
                                   rtol=0, atol=WHOLE_ATOL)


@pytest.mark.parametrize("hw,chunk,want", [((720, 1280), 8, 8), ((1080, 1920), 8, 1),
                                           ((64, 96), 8, 8), ((720, 1280), 2, 2)])
def test_pair_chunk_fits_the_matching_budget(hw, chunk, want):
    assert gmflow.pair_chunk(*hw, GmflowConfig(), chunk) == want
    assert gmflow.match_bytes(720, 1280) == 2 * 4 * (92 * 160) ** 2  # 1.73 GB: 736x1280 padded


def test_pair_chunk_refuses_4k():
    with pytest.raises(ValueError, match="do not fit"):
        gmflow.pair_chunk(2160, 3840, GmflowConfig(), 2)


def test_default_params_draws_gmflow_from_the_seed():
    cfg = Config(flow=GmflowConfig(), seed=4)
    a = default_params(cfg, device="cpu", ckpt_dir="/nonexistent")
    b = gmflow.init_params(4, device="cpu")
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_gmflow_config_json_round_trip_beside_the_jax_json():
    cfg = Config(flow=GmflowConfig(compute_dtype="float32"))
    back = Config.from_json(cfg.to_json())
    assert back == cfg and isinstance(back.flow, GmflowConfig)
    assert '"net": "gmflow"' in cfg.to_json()
    raft_cfg = Config(flow=tcfg.RaftConfig())
    assert isinstance(Config.from_json(raft_cfg.to_json()).flow, tcfg.RaftConfig)
    port = tcfg.Config.from_json(jcfg.preset("full_720p").to_json())
    assert isinstance(port.flow, tcfg.FlowConfig) and port == tcfg.preset("full_720p")
    with pytest.raises(ValueError):
        GmflowConfig(net="raft")


def test_spans_of_a_chunk(params):
    frames = _frames(t=3)
    trace.clear()
    with trace.recording():
        clip_flow(params, frames, Config(flow=GmflowConfig()))
    recs = trace.records()
    trace.clear()
    chunk = next(r["id"] for r in recs if r["name"] == "vstab.flow.chunk")
    mine = [r for r in recs if r["name"].startswith("vstab.flow.gmflow.")]
    assert all(r["parent"] == chunk for r in mine)
    names = [r["name"].rpartition(".")[2] for r in mine]
    assert names == ["encode"] + ["transformer", "match", "propagate"] * 2 + ["upsample"]
    by = {(r["name"].rpartition(".")[2], r["attrs"].get("scale")): r["attrs"] for r in mine}
    pairs = 8  # the chunk is padded to its full 8 pairs
    assert by[("encode", None)]["frames"] == pairs + 1
    t8, t4 = by[("transformer", 8)], by[("transformer", 4)]
    assert (t8["tokens"], t8["window_tokens"], t4["tokens"], t4["window_tokens"]) == (96, 24, 384, 6)
    assert t8["attn_flops"] == 12 * 2 * 2 * (2 * pairs * 96) * 24 * 128
    assert by[("match", 8)]["kind"] == "global" and by[("match", 4)]["kind"] == "local"
    assert by[("match", 8)]["match_flops"] == pairs * 96 * 96 * (2 * 128 + 4)
    assert by[("match", 4)]["match_flops"] == pairs * 384 * 81 * (2 * 128 + 4)
    assert (by[("propagate", 8)]["radius"], by[("propagate", 4)]["radius"]) == (-1, 1)
    assert by[("propagate", 4)]["prop_flops"] == pairs * 384 * (4 * 128 * 128 + 9 * (2 * 128 + 4))
    assert math.isclose(gmflow.attn_flops(1, 92, 160, 2), 665.7e9, rel_tol=1e-3)


def test_the_published_initialisers_stay_available_for_a_checkpoint():
    """A checkpoint's state dict (GMFlow's `model` entry) goes straight in:
    the port reads nothing but GMFlow's names."""
    p = {k: v.clone() for k, v in gmflow.init_params(1, device="cpu").items()}
    flow = gmflow.estimate_flow_pairs(gmflow.prepare(p, F32), _frames(t=2), F32)
    assert flow.shape == (1, 64, 96, 2) and torch.isfinite(flow).all()
