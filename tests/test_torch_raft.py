"""vstab_torch's RAFT held against the plain RAFT of the benchmark's
reference, `h100bench/reference/raft.py` (plain float32 torch following the
published code, importing nothing of `vstab_torch`), on the CPU, at the
published widths on 64x96 frames with seeded random weights (the JAX
package has no RAFT).

Tolerances, each with its reason:
- float32 runs: 1e-4 abs (flow in px, features, samples). The two compute the
  same operations in float32; the port keeps channels-last memory and sums
  the convolutions in another order, which moves the last bits (observed
  under 1e-5 px over the 20 iterations).
- bfloat16 runs (the configuration's precision): the port rounds the
  encoders' and the update block's activations and weights to 8 mantissa
  bits (0.4% a value) and the reference does not; over 20 iterations that
  leaves a mean gap under 2% of the mean flow and a largest under 1 px
  (observed 0.6% and 0.19 px on flows of 8.9 px; stopping after 10 of the
  20 iterations reads 49% and 9 px).
- stabilize: the same render bucket, and output within 1e-3 of the output
  rendered from the reference's flow on at least 99.9% of the values, as
  `tests/test_torch_pipeline.py` holds the PWC-Net path.
"""

import dataclasses
import math

import pytest
import torch

import vstab.core.config as jcfg
from h100bench.reference import raft as ref
import vstab_torch
from vstab_torch.core import config as tcfg
from vstab_torch.core.config import Config, RaftConfig
from vstab_torch.flow import raft
from vstab_torch.kernels import corr_lookup, corr_lookup_plain
from vstab_torch.pipeline import clip_flow, default_params, stabilize_from_flow
from vstab_torch.utils import trace

torch.set_num_threads(1)
F32 = RaftConfig(compute_dtype="float32")
ATOL = 1e-4


def _ref_flow(p, frames, iters=20):
    """The reference's consecutive-pair flow of frames [T,H,W,3], in float32."""
    flow = {"hidden": 128, "corr_levels": 4, "corr_radius": 4, "iters": iters}
    return torch.cat(list(ref.pair_flows(p, frames, flow)))


def _coords_grid(n, h, w):
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return torch.stack([xx, yy], dim=0).float()[None].repeat(n, 1, 1, 1)


@pytest.fixture(scope="module")
def params():
    p = raft.init_params(0, device="cpu")
    # batch-norm statistics away from 0 / 1, so that cnet's norms do something
    g = torch.Generator().manual_seed(5)
    for k, v in p.items():
        if ".norm" in k and k.endswith(("running_mean", ".bias")):
            p[k] = 0.1 * torch.randn(v.shape, generator=g)
        if ".norm" in k and k.endswith(("running_var", ".weight")):
            p[k] = 0.5 + torch.rand(v.shape, generator=g)
    for k in list(p):  # norm3 is downsample.1: one module under two names
        if ".norm3." in k:
            p[k.replace("norm3", "downsample.1")] = p[k]
    return p


def _frames(t=3, h=64, w=96, seed=1):
    return torch.rand((t, h, w, 3), generator=torch.Generator().manual_seed(seed))


def _images(frames):
    return frames.permute(0, 3, 1, 2) * 2.0 - 1.0


def test_state_dict_has_rafts_names_and_shapes(params):
    want = {
        "fnet.conv1.weight": (64, 3, 7, 7), "fnet.layer1.0.conv1.weight": (64, 64, 3, 3),
        "fnet.layer2.0.downsample.0.weight": (96, 64, 1, 1), "fnet.conv2.weight": (256, 128, 1, 1),
        "cnet.norm1.running_var": (64,), "cnet.layer3.0.norm3.weight": (128,),
        "cnet.layer3.0.downsample.1.weight": (128,), "cnet.norm1.num_batches_tracked": (),
        "cnet.conv2.weight": (256, 128, 1, 1),
        "update_block.encoder.convc1.weight": (256, 324, 1, 1),
        "update_block.encoder.convc2.weight": (192, 256, 3, 3),
        "update_block.encoder.convf1.weight": (128, 2, 7, 7),
        "update_block.encoder.conv.weight": (126, 256, 3, 3),
        "update_block.gru.convz1.weight": (128, 384, 1, 5),
        "update_block.gru.convq2.weight": (128, 384, 5, 1),
        "update_block.flow_head.conv1.weight": (256, 128, 3, 3),
        "update_block.flow_head.conv2.bias": (2,),
        "update_block.mask.0.weight": (256, 128, 3, 3), "update_block.mask.2.weight": (576, 256, 1, 1),
    }
    for k, shape in want.items():
        assert tuple(params[k].shape) == shape, k
    assert not any(k.startswith("module.") or ".norm" in k and k.startswith("fnet.") for k in params)
    assert set(params) == set(raft.RAFT().state_dict())
    n = sum(v.numel() for k, v in params.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))
            and ".downsample.1." not in k)
    assert n == 5_257_536  # RAFT large's parameter count


def test_init_params_uses_rafts_initialisers():
    a, b = raft.init_params(7, device="cpu"), raft.init_params(7, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["fnet.layer1.0.conv1.weight"]  # kaiming normal, fan_out = 64 * 9
    assert abs(float(w.std()) / (2.0 / (64 * 9)) ** 0.5 - 1.0) < 0.05
    u = a["update_block.gru.convz1.weight"]  # torch's default: U(-1/sqrt(fan_in), ..)
    assert float(u.abs().max()) <= (384 * 5) ** -0.5
    assert torch.equal(a["cnet.norm1.weight"], torch.ones(64))
    assert torch.equal(a["cnet.norm1.running_var"], torch.ones(64))
    assert not torch.equal(a["fnet.conv1.weight"], raft.init_params(8, device="cpu")["fnet.conv1.weight"])


@pytest.mark.parametrize("name,kind", [("fnet", "instance"), ("cnet", "batch")])
def test_encoder_matches_reference(params, name, kind):
    x = _images(_frames())
    got = raft.encode(raft.prepare(params, F32), name, x.contiguous(memory_format=torch.channels_last), kind)
    want = ref.encoder(params, name, x.contiguous(), kind == "batch", "f32")
    assert got.shape == want.shape == (3, 256, 8, 12)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def _pyramid_and_coords(params, spread):
    x = _images(_frames())
    f = ref.encoder(params, "fnet", x, False, "f32")
    pyr = ref.corr_pyramid(f[:-1], f[1:], 4)
    g = torch.Generator().manual_seed(3)
    base = _coords_grid(2, 8, 12)
    coords = base + spread * torch.randn(base.shape, generator=g)  # [B,2,H,W], some far outside
    return pyr, coords


@pytest.mark.parametrize("spread", [0.7, 6.0, 40.0])
def test_plain_lookup_matches_reference(params, spread):
    pyr, coords = _pyramid_and_coords(params, spread)
    want = ref.lookup(pyr, coords, 4)
    got = corr_lookup([p[:, 0] for p in pyr], coords.permute(0, 2, 3, 1).contiguous(), 4)
    assert got.shape == (2, 8, 12, 324)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("who", ["port", "reference"])
@pytest.mark.parametrize("frac", [0.0, 0.25])
def test_lookup_samples_x_on_the_slow_index_and_zeros_outside(who, frac):
    """Level l of every pixel holds 1000 l + 100 y + x + 1 at (x, y): channel
    l*81 + a*9 + b of a pixel at (cx, cy) reads (cx/2^l + a - 4, cy/2^l + b - 4)."""
    h, w, levels, r = 5, 7, 2, 4
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    img = (100 * yy + xx + 1).float()
    pyr = [(img + 1000 * lvl).expand(h * w, h, w).contiguous() for lvl in range(levels)]
    pyr[1] = pyr[1][:, :3, :4].contiguous()  # a smaller second level, as pooling gives
    coords = torch.stack([xx, yy], dim=-1).float()[None] + frac  # [1,H,W,2]
    if who == "port":
        out = corr_lookup_plain(pyr, coords, r)[0]
    else:
        out = ref.lookup([p[:, None] for p in pyr], coords.permute(0, 3, 1, 2), r)[0].permute(1, 2, 0)
    for (cy, cx) in ((0, 0), (2, 3), (4, 6)):
        for lvl in range(levels):
            lh, lw = pyr[lvl].shape[-2:]
            for a in range(2 * r + 1):
                for b in range(2 * r + 1):
                    x = (cx + frac) / 2**lvl + a - r
                    y = (cy + frac) / 2**lvl + b - r
                    want = 0.0
                    for ty, wy in ((int(y // 1), 1 - y % 1), (int(y // 1) + 1, y % 1)):
                        for tx, wx in ((int(x // 1), 1 - x % 1), (int(x // 1) + 1, x % 1)):
                            if 0 <= ty < lh and 0 <= tx < lw:
                                want += wy * wx * (1000 * lvl + 100 * ty + tx + 1)
                    got = float(out[cy, cx, lvl * 81 + a * 9 + b])
                    assert abs(got - want) < 1e-3, (cy, cx, lvl, a, b, got, want)


def test_one_update_step_matches_reference(params):
    pyr, coords = _pyramid_and_coords(params, 2.0)
    g = torch.Generator().manual_seed(4)
    net = torch.tanh(torch.randn((2, 128, 8, 12), generator=g))
    inp = torch.relu(torch.randn((2, 128, 8, 12), generator=g))
    corr = ref.lookup(pyr, coords, 4)
    flow = coords - _coords_grid(2, 8, 12)
    want_h, want_d = ref.update(params, net, inp, corr, flow, "f32")
    cl = torch.channels_last
    got_h, got_d = raft.update(raft.prepare(params, F32), net.contiguous(memory_format=cl),
                               inp.contiguous(memory_format=cl), corr.contiguous(memory_format=cl),
                               flow.contiguous(memory_format=cl))
    torch.testing.assert_close(got_h, want_h, rtol=0, atol=ATOL)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=ATOL)


def test_convex_upsampling_matches_reference(params):
    g = torch.Generator().manual_seed(6)
    net = torch.tanh(torch.randn((2, 128, 8, 12), generator=g))
    flow = 3.0 * torch.randn((2, 2, 8, 12), generator=g)
    want = ref.upsample(params, net, flow, "f32")
    got = raft.upsample(raft.prepare(params, F32), net.contiguous(memory_format=torch.channels_last), flow)
    assert got.shape == (2, 2, 64, 96)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_convex_upsampling_of_a_constant_flow_is_eight_times_it(params):
    net = torch.zeros((1, 128, 4, 6))
    flow = torch.tensor([1.5, -0.25]).view(1, 2, 1, 1).expand(1, 2, 4, 6).contiguous()
    up = raft.upsample(raft.prepare(params, F32), net, flow)
    inner = up[:, :, 8:-8, 8:-8]  # away from unfold's zero border
    torch.testing.assert_close(inner, 8.0 * flow[:, :, :1, :1].expand_as(inner), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_matches_reference(params, dtype):
    frames = _frames()
    want = _ref_flow(params, frames)
    cfg = RaftConfig(compute_dtype=dtype)
    got = raft.estimate_flow_pairs(raft.prepare(params, cfg), frames, cfg)
    assert got.shape == (2, 64, 96, 2) and got.dtype == torch.float32
    gap = (got - want).abs()
    if dtype == "float32":
        assert float(gap.max()) < ATOL
    else:
        assert float(gap.mean()) < 0.02 * float(want.abs().mean()) and float(gap.max()) < 1.0
    assert float(want.abs().mean()) > 1.0  # the flow is not trivially small


def test_flow_pads_as_input_padder(params):
    frames = _frames(t=2, h=60, w=90)
    want = _ref_flow(params, frames)
    got = raft.estimate_flow_pairs(raft.prepare(params, F32), frames, F32)
    assert got.shape == (1, 60, 90, 2)
    assert float((got - want).abs().max()) < ATOL


@pytest.mark.parametrize("iters", [1, 5])
def test_iterations_follow_the_config(params, iters):
    frames = _frames(t=2)
    cfg = dataclasses.replace(F32, iters=iters)
    want = _ref_flow(params, frames, iters=iters)
    got = raft.estimate_flow_pairs(raft.prepare(params, cfg), frames, cfg)
    assert float((got - want).abs().max()) < ATOL


def test_stabilize_with_raft_matches_the_reference_flow(params):
    frames = _frames(t=11, seed=2)
    cfg = Config(flow=F32)
    out, diags = vstab_torch.stabilize(frames, params, cfg, device="cpu")
    want, _ = stabilize_from_flow(frames, _ref_flow(params, frames), cfg)
    assert out.shape == frames.shape
    close = ((out - want).abs() <= 1e-3).float().mean()
    assert float(close) >= 0.999


def test_clip_flow_chunks_raft_pairs_as_one_call(params):
    frames = _frames(t=4, seed=3)
    cfg = Config(flow=F32)
    whole = raft.estimate_flow_pairs(raft.prepare(params, F32), frames, F32)
    for chunk in (1, 2, 8):
        torch.testing.assert_close(clip_flow(params, frames, cfg, pair_chunk=chunk), whole,
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw,chunk,want", [((720, 1280), 8, 8), ((1080, 1920), 8, 2),
                                           ((64, 96), 8, 8), ((1080, 1920), 1, 1)])
def test_pair_chunk_fits_the_correlation_budget(hw, chunk, want):
    assert raft.pair_chunk(*hw, RaftConfig(), chunk) == want


def test_pair_chunk_refuses_4k():
    with pytest.raises(ValueError, match="do not fit"):
        raft.pair_chunk(2160, 3840, RaftConfig(), 2)


def test_default_params_draws_raft_from_the_seed():
    cfg = Config(flow=RaftConfig(), seed=4)
    a = default_params(cfg, device="cpu", ckpt_dir="/nonexistent")
    b = raft.init_params(4, device="cpu")
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_raft_config_json_round_trip_beside_the_jax_json():
    cfg = Config(flow=RaftConfig(iters=12, compute_dtype="float32"))
    back = Config.from_json(cfg.to_json())
    assert back == cfg and isinstance(back.flow, RaftConfig)
    assert '"net": "raft"' in cfg.to_json()
    for name in ("full_720p", "affine_480p"):
        port = tcfg.Config.from_json(jcfg.preset(name).to_json())
        assert isinstance(port.flow, tcfg.FlowConfig) and port == tcfg.preset(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(jcfg.preset(name))
    with pytest.raises(ValueError):
        RaftConfig(net="pwcnet")


@pytest.mark.parametrize("field", ["hidden", "context"])
def test_raft_config_refuses_widths_other_than_rafts(field):
    with pytest.raises(ValueError, match="128"):
        RaftConfig(**{field: 96})


def test_spans_of_a_chunk(params):
    frames = _frames(t=3)
    trace.clear()
    with trace.recording():
        clip_flow(params, frames, Config(flow=RaftConfig()))
    recs = {r["name"]: r for r in trace.records()}
    trace.clear()
    chunk = recs["vstab.flow.chunk"]["id"]
    for name in ("encode", "corr", "update", "upsample"):
        assert recs[f"vstab.flow.raft.{name}"]["parent"] == chunk
    pairs = 8  # the chunk is padded to its full 8 pairs
    corr = recs["vstab.flow.raft.corr"]["attrs"]
    assert corr["corr_bytes"] == pairs * raft.pyramid_bytes(8, 12, 4)
    assert corr["gemm"] == "f32"  # the tensor-core route is the card's alone
    upd = recs["vstab.flow.raft.update"]["attrs"]
    assert upd["iters"] == 20 and upd["lookup_bytes"] == 20 * pairs * 96 * (4 * 400 + 8 + 324 * 2)


def _corr_pyramid_written_out(f1, f2, levels):
    """The f32 route of `raft.corr_pyramid` written out: both upcast, one
    f32 product, the division, the 2x2 poolings."""
    n, c, h, w = f1.shape
    a = f1.float().permute(0, 2, 3, 1).reshape(n, h * w, c)
    b = f2.float().permute(0, 2, 3, 1).reshape(n, h * w, c)
    corr = torch.bmm(a, b.transpose(1, 2)).div_(math.sqrt(c)).view(n * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(levels - 1):
        pyramid.append(torch.nn.functional.avg_pool2d(pyramid[-1], 2, stride=2))
    return [t.view(n * h * w, *t.shape[-2:]) for t in pyramid]


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corr_pyramid_on_the_cpu_is_the_f32_route_bit_for_bit(dtype, channels_last):
    g = torch.Generator().manual_seed(5)
    fmap = torch.randn((3, 256, 12, 20), generator=g).to(dtype)
    if channels_last:
        fmap = fmap.contiguous(memory_format=torch.channels_last)
    assert raft.corr_gemm(fmap[:-1], fmap[1:]) == "f32"
    got = raft.corr_pyramid(fmap[:-1], fmap[1:], 4)
    want = _corr_pyramid_written_out(fmap[:-1], fmap[1:], 4)
    assert [tuple(t.shape) for t in got] == [(480, 12, 20), (480, 6, 10), (480, 3, 5), (480, 1, 2)]
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and torch.equal(x, y)


# Meta tensors stand in for the card's: the selector reads dtype, `is_cuda`
# and `requires_grad`, never the values.
@pytest.mark.parametrize("case,want", [("card_bf16", "bf16_f32acc"), ("cpu_bf16", "f32"), ("card_f32", "f32"),
                                       ("card_bf16_f32", "f32"), ("card_bf16_requires_grad", "f32")])
def test_corr_gemm_takes_the_tensor_cores_only_for_bf16_card_features_without_gradient(monkeypatch, case, want):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: case.startswith("card")))
    f1 = torch.empty((2, 8, 4, 4), dtype=torch.float32 if case == "card_f32" else torch.bfloat16, device="meta")
    f2 = f1.float() if case == "card_bf16_f32" else f1.clone()
    f1.requires_grad_(case.endswith("requires_grad"))
    assert raft.corr_gemm(f1, f2) == want


def test_lookup_refuses_what_it_cannot_take():
    pyr = [torch.zeros((2, 3, 4), device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        corr_lookup(pyr, torch.zeros((1, 1, 2, 2), device="meta"))
