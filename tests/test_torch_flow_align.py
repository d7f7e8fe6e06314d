"""PWC-Net's aligned layout (`vstab_torch.flow.pwcnet.prepare`,
`aligned_params`) on the CPU: each estimator's input and the context
network's end in zero channels up to a multiple of 8, and every weight that
reads them has zero columns there.

Each layer fed the zero-padded input and the widened weight equals the
published call: its convolutions exactly in f32, and within one bf16 ulp
(a relative 2^-7) in bf16, since the zero channels' products are exact
zeros; the f32 prediction heads (a matrix product whose rows grow by the
zero columns, which a BLAS may sum in another order) within 1e-5 of the
largest output. Whole nets: within 2e-3 px, the tolerance of
`test_trained_net_matches_reference` (observed: 0 on the tiny net,
6.2e-6 px in f32 and 2.6e-6 px in bf16 on `flow_086000`).
"""

import dataclasses
import os

import pytest
import torch
import torch.nn.functional as F

from vstab_torch import pipeline
from vstab_torch.core import config as tcfg
from vstab_torch.eval.synthetic import make_shaky_clip
from vstab_torch.flow import pwcnet, raft
from vstab_torch.flow import train as ttrain
from vstab_torch.flow.context import ContextNet
from vstab_torch.flow.estimator import FlowEstimator, UpBlock
from vstab_torch.flow.pwcnet import (
    ALIGN,
    _layout,
    aligned_pad,
    aligned_params,
    build_net,
    estimate_flow_pairs,
    init_params,
    prepare,
)
from vstab_torch.utils import trace
from vstab_torch.utils.checkpoint import load_params, params_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "ckpts", "flow_086000.msgpack")
BF16 = tcfg.FlowConfig()  # the published widths, bf16: the cells' net
F32 = tcfg.FlowConfig(compute_dtype="float32")
TINY = tcfg.FlowConfig(pyramid_channels=(8, 16, 24), estimator_channels=(16, 16),
                       context_dilations=(1, 2, 1), search_radius=2, compute_dtype="float32")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LEVELS = (5, 4, 3, 2, 1)  # pyramid index of each estimator, coarsest first
PADS = {5: 3, 4: 3, 3: 3, 2: 3, 1: 3}  # zero channels at the published widths
CONTEXT_PAD = 6  # [565 + 3 zeros, flow 2] -> 576
PAPER_WIDTHS = {5: 277, 4: 213, 3: 181, 2: 149, 1: 117}


@pytest.fixture(scope="module")
def published():
    return init_params(0, F32, "cpu")


def _sub(params, prefix):
    return {k[len(prefix) + 1 :]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _load(module, params, prefix):
    module.load_state_dict(_sub(params, prefix), strict=True, assign=True)
    return module.eval()


def _stack_input(c, n=2, h=6, w=10, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    # a leaky-ReLU stack, exact in bf16
    return F.leaky_relu(torch.randn((n, h, w, c), generator=g), 0.1).bfloat16().to(dtype)


def _zeros_after(x, n):
    return torch.cat([x, x.new_zeros((*x.shape[:-1], n))], dim=-1)


def _assert_equal(got, want, dtype):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_layout_at_the_published_widths():
    ests, ctx = _layout(BF16, ALIGN)
    assert {i: c for i, (c, _) in ests.items()} == PAPER_WIDTHS
    assert {i: p for i, (_, p) in ests.items()} == PADS
    assert ctx == (565 + 3 + 2, CONTEXT_PAD)
    assert all(_layout(BF16, 1)[0][i][1] == 0 for i in LEVELS) and _layout(BF16, 1)[1][1] == 0
    wide, pub = pwcnet.PWCNet(BF16, device="meta", align=ALIGN), pwcnet.PWCNet(BF16, device="meta")
    assert wide.pads == PADS and wide.context.pad == CONTEXT_PAD
    assert set(pub.pads.values()) == {0} and pub.context.pad == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("idx", LEVELS)
def test_estimator_on_the_aligned_input_equals_the_published(published, idx, dtype):
    dt = DTYPES[dtype]
    cin, pad = PAPER_WIDTHS[idx], PADS[idx]
    pub = _load(FlowEstimator(cin, dtype=dt, device="meta"), published, f"estimator{idx}")
    wide = _load(FlowEstimator(cin + pad, dtype=dt, device="meta"), aligned_params(published, F32),
                 f"estimator{idx}")
    x = _stack_input(cin, seed=idx, dtype=dt)
    up = None if idx == 5 else torch.randn((2, 6, 10, 2), generator=torch.Generator().manual_seed(idx))
    with torch.no_grad():
        flow, feat = pub(x, up)
        flow_w, feat_w = wide(_zeros_after(x, pad), up)
    assert feat_w.shape[-1] % ALIGN == 0 and feat_w.shape[-1] == feat.shape[-1] + pad
    _assert_equal(feat_w[..., : feat.shape[-1]], feat, dt)
    assert not feat_w[..., feat.shape[-1] :].any()
    scale = float(flow.abs().max())
    torch.testing.assert_close(flow_w, flow, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_context_on_the_aligned_input_equals_the_published(published, dtype):
    dt = DTYPES[dtype]
    pub = _load(ContextNet(567, dtype=dt, device="meta"), published, "context")
    wide = _load(ContextNet(567 + 3, dtype=dt, device="meta", pad=CONTEXT_PAD),
                 aligned_params(published, F32), "context")
    assert wide.dconv0.weight.shape[1] == 576
    feat = _stack_input(565, seed=11, dtype=dt)
    flow = torch.randn((2, 6, 10, 2), generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        want, got = pub(feat, flow), wide(_zeros_after(feat, 3), flow)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    with torch.no_grad():  # the first convolution alone, with its zeros between the stack and the flow
        x = torch.cat([feat, flow.to(dt)], dim=-1)
        xw = _zeros_after(torch.cat([_zeros_after(feat, 3), flow.to(dt)], dim=-1), CONTEXT_PAD)
        _assert_equal(wide.dconv0(xw), pub.dconv0(x), dt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("idx", LEVELS[1:])
def test_up_block_on_the_aligned_stack_equals_the_published(published, idx, dtype):
    dt = DTYPES[dtype]
    feat_in = PAPER_WIDTHS[idx + 1] + 448
    pub = _load(UpBlock(feat_in, dtype=dt, device="meta"), published, f"up{idx}")
    wide = _load(UpBlock(feat_in + PADS[idx + 1], dtype=dt, device="meta"),
                 aligned_params(published, F32), f"up{idx}")
    feat = _stack_input(feat_in, h=3, w=5, seed=idx, dtype=dt)
    flow = torch.randn((2, 3, 5, 2), generator=torch.Generator().manual_seed(idx))
    with torch.no_grad():
        (uf, ufeat), (uf_w, ufeat_w) = pub(flow, feat), wide(flow, _zeros_after(feat, PADS[idx + 1]))
    torch.testing.assert_close(uf_w, uf, rtol=0, atol=0)
    _assert_equal(ufeat_w, ufeat, dt)


def _frames():
    g = torch.Generator().manual_seed(4)
    base = torch.rand((80, 150, 3), generator=g)
    return torch.stack([base[8:72, 8:136], base[6:70, 11:139], base[9:73, 13:141]])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("net", ["tiny", "flow_086000"])
def test_flow_pairs_in_the_aligned_layout_equal_the_published(published, net, dtype):
    """bf16: `prepare`'s state dict (the path's); f32, where `prepare`
    keeps the published layout: `aligned_params`."""
    base = TINY if net == "tiny" else F32
    cfg = dataclasses.replace(base, compute_dtype=dtype)
    params = (init_params(1, cfg, "cpu") if net == "tiny"
              else params_from_jax(load_params(CKPT)))
    frames = _frames()
    with torch.inference_mode():
        want = estimate_flow_pairs(params, frames, cfg)
        wide = prepare(params, cfg) if dtype == "bfloat16" else aligned_params(params, cfg)
        assert aligned_pad(wide, cfg) > 0
        got = estimate_flow_pairs(wide, frames, cfg)
    assert got.shape == want.shape == (2, 64, 128, 2)
    assert float(want.abs().max()) > (0.01 if net == "tiny" else 0.5)  # a motion, not zeros
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


def test_prepare_leaves_its_input_and_adds_only_zeros(published):
    kept = {k: v.clone() for k, v in published.items()}
    with torch.inference_mode():
        q = prepare(published, BF16)
    assert set(q) == set(published)
    for k, v in published.items():
        assert v.dtype == torch.float32 and torch.equal(v, kept[k])
    f32_layers = ("predict_flow", "predict_res", "upflow")
    for k, v in q.items():
        f32 = any(f".{n}." in k for n in f32_layers)
        assert v.dtype == (torch.float32 if f32 else torch.bfloat16), k
        p = published[k].to(v.dtype)
        if v.shape == p.shape:
            assert torch.equal(v, p), k
            continue
        if k.startswith("estimator"):  # [cout, cin + pad, 3, 3]: zeros at the end of the input
            idx = int(k[len("estimator")])
            assert v.shape[1] == p.shape[1] + PADS[idx] and v.shape[1] % ALIGN == 0, k
            assert torch.equal(v[:, : p.shape[1]], p) and not v[:, p.shape[1] :].any(), k
        elif k.startswith("up"):  # [cin + pad, 2, 4, 4]: zero rows at the end
            assert v.shape[0] == p.shape[0] + PADS[int(k[2]) + 1] and v.shape[0] % ALIGN == 0, k
            assert torch.equal(v[: p.shape[0]], p) and not v[p.shape[0] :].any(), k
        else:  # context.dconv0: [128, 565 | 3 zeros | flow 2 | 6 zeros]
            assert k == "context.dconv0.weight" and v.shape[1] == 576, k
            assert torch.equal(v[:, :565], p[:, :565]) and torch.equal(v[:, 568:570], p[:, 565:])
            assert not v[:, 565:568].any() and not v[:, 570:].any()
    assert aligned_pad(q, BF16) == 21 and aligned_pad(published, BF16) == 0
    with torch.inference_mode():  # q's tensors were made there
        net = build_net(q, BF16)
    assert net.pads == PADS and net.context.pad == CONTEXT_PAD


def test_prepare_keeps_the_published_layout_in_f32_and_under_autograd(published):
    with torch.inference_mode():
        f32 = prepare(published, F32)
    with torch.enable_grad():
        graph = prepare(published, BF16)
    for q in (f32, graph):
        assert set(q) == set(published) and all(q[k] is v for k, v in published.items())


def _flow_span(run):
    trace.clear()
    with trace.recording():
        run()
    recs = [r for r in trace.records() if r["name"] == "vstab.flow"]
    trace.clear()
    return recs


@pytest.mark.parametrize("case", ["bf16", "f32", "raft"])
def test_flow_span_counts_the_aligned_zero_channels(case):
    clip = torch.from_numpy(make_shaky_clip(t=3, h=64, w=96, seed=0)[0])
    if case == "raft":
        cfg = tcfg.Config(flow=tcfg.RaftConfig(iters=1))
        params = raft.init_params(0, cfg.flow, "cpu")
    else:
        cfg = tcfg.Config(flow=BF16 if case == "bf16" else F32)
        params = init_params(0, cfg.flow, "cpu")
    recs = _flow_span(lambda: pipeline.clip_flow(params, clip, cfg))
    assert len(recs) == 1
    assert recs[0]["attrs"]["aligned_pad"] == (21 if case == "bf16" else 0)


def test_a_training_step_takes_the_published_layout():
    flow_cfg = tcfg.FlowConfig(pyramid_channels=(8, 12, 16), estimator_channels=(16, 12),
                               compute_dtype="bfloat16", output_level=1)
    params = init_params(0, flow_cfg, "cpu")
    net = build_net(params, flow_cfg)
    assert set(net.pads.values()) == {0} and net.context.pad == 0
    with torch.enable_grad():
        assert all(prepare(params, flow_cfg)[k] is v for k, v in params.items())
    opt = ttrain.make_optimizer(net.parameters(), lr=1e-4)
    step = ttrain.make_train_step(net, opt, "supervised", ttrain.cosine_schedule(opt, 10, 0.02))
    batch = ttrain._sample_batch(torch.Generator().manual_seed(0), torch.rand(4, 64, 64, 3), 2, 4.0)
    step(batch)
    assert net.estimator2.conv0.weight.shape[1] == 81 + 16  # the published width, no zeros
