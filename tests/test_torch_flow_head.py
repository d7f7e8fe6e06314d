"""The flow networks' f32 prediction heads (`vstab_torch.flow.layers.
predict`, `conv3x3_to2`) on the CPU: the matrix-product-and-col2im form held
to `F.conv2d` in f64, the estimator and the context network with and
without autograd, and the count of heads a chunk of `clip_flow` took in
that form (calls of `conv3x3_to2`, counted through a wrapper).

Tolerance of the head against f64: 1e-5 of the output's largest magnitude.
The head sums 9*C (up to 6525) f32 products, as the convolution does, in
another order. Each f32 addition rounds by at most 2^-24 (6e-8) of its
running sum, and over K terms of mixed sign the roundings add up like a
random walk of sqrt(K) (81) steps: about 5e-6 of the output's scale at
most (observed here: under 2.3e-7). Weights rounded to bf16 (2^-9 each), one
bf16 product, read 6e-5 to 2.2e-3 on the same inputs (the control below).
"""

import pytest
import torch
import torch.nn.functional as F

import vstab_torch
from vstab_torch import pipeline
from vstab_torch.core import config as tcfg
from vstab_torch.eval.synthetic import make_shaky_clip
from vstab_torch.flow import layers, raft
from vstab_torch.flow import train as ttrain
from vstab_torch.flow.context import ContextNet
from vstab_torch.flow.estimator import FlowEstimator
from vstab_torch.flow.pwcnet import build_net, init_params

torch.set_num_threads(1)
RTOL = 1e-5
# The estimators' stacks (cost volume 81 + pyramid channels + 4, then the
# dense layers' 448) and the context network's last layer.
CHANNELS = (565, 597, 629, 661, 725, 32)
SHAPES = ((1, 1, 1), (2, 1, 7), (1, 5, 1), (2, 5, 9))


def _inputs(c, n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    # The path's input: a leaky-ReLU stack in bf16, upcast exactly to f32.
    x = F.leaky_relu(torch.randn((n, h, w, c), generator=g), 0.1).bfloat16().float()
    head = layers.Conv(c, 2, dtype=torch.float32)
    head.reset_parameters(g)
    with torch.no_grad():
        head.bias.normal_(generator=g)
    return x, head, torch.randn((n, h, w, 2), generator=g)


@torch.no_grad()
def _conv_f64(x, head, residual=None):
    y = F.conv2d(x.double().permute(0, 3, 1, 2), head.weight.double(), head.bias.double(),
                 padding=1).permute(0, 2, 3, 1)
    return y if residual is None else y + residual.double()


def _rel_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,h,w", SHAPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_head_matches_conv2d_in_f64(c, n, h, w, residual):
    x, head, r = _inputs(c, n, h, w, seed=c + h + w)
    r = r if residual else None
    with torch.no_grad():
        got = layers.conv3x3_to2(x, head.weight, head.bias, r)
    assert got.shape == (n, h, w, 2) and got.dtype == torch.float32 and got.is_contiguous()
    assert _rel_err(got, _conv_f64(x, head, r)) < RTOL


@pytest.mark.parametrize("c", [565, 725])
def test_head_with_bf16_weights_misses_the_tolerance(c):
    """The control: the same head with its weights rounded to bf16 (one
    bf16 product) reads far over RTOL."""
    x, head, _ = _inputs(c, 2, 5, 9, seed=c)
    with torch.no_grad():
        got = layers.conv3x3_to2(x, head.weight.bfloat16().float(), head.bias, None)
    assert _rel_err(got, _conv_f64(x, head)) > 10 * RTOL


@pytest.mark.parametrize("shape", [(3, 8, 3, 3), (1, 8, 3, 6), (2, 8, 1, 1)])
def test_head_refuses_other_weights(shape):
    with pytest.raises(ValueError, match=r"\[2,8,3,3\]"):
        layers.conv3x3_to2(torch.zeros((1, 3, 3, 8)), torch.zeros(shape), torch.zeros(2))


@pytest.fixture
def heads(monkeypatch):
    """Calls of `layers.conv3x3_to2` (the GEMM form of a head) from here on:
    a list that grows by one a call."""
    calls, real = [], layers.conv3x3_to2

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(layers, "conv3x3_to2", counted)
    return calls


def _estimator():
    torch.manual_seed(3)
    est = FlowEstimator(117, dtype=torch.float32)
    assert est.out_channels == 565
    return est


@pytest.mark.parametrize("with_upflow", [False, True])
def test_estimator_without_a_graph_equals_autograd(with_upflow, heads):
    est = _estimator()
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 7, 9, 117), generator=g)
    up = torch.randn((2, 7, 9, 2), generator=g) if with_upflow else None
    with torch.no_grad():
        fast, feat = est(x, up)
    assert len(heads) == 1
    slow, feat_slow = est(x, up)
    assert len(heads) == 1  # autograd keeps the convolution
    assert slow.requires_grad and not fast.requires_grad
    torch.testing.assert_close(feat, feat_slow.detach(), rtol=0, atol=0)
    assert _rel_err(fast, slow.detach().double()) < RTOL


def test_context_without_a_graph_equals_autograd(heads):
    torch.manual_seed(5)
    ctx = ContextNet(567, dtype=torch.float32)
    g = torch.Generator().manual_seed(6)
    feat, flow = torch.randn((2, 6, 11, 565), generator=g), torch.randn((2, 6, 11, 2), generator=g)
    with torch.inference_mode():
        fast = ctx(feat, flow)
    assert len(heads) == 1
    slow = ctx(feat, flow)
    assert len(heads) == 1
    assert _rel_err(fast, slow.detach().double()) < RTOL


def test_autograd_takes_the_convolution_and_backpropagates(heads):
    est = _estimator()
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 5, 6, 117), generator=g)
    up = torch.randn((2, 5, 6, 2), generator=g, requires_grad=True)
    flow, _ = est(x, up)
    (flow ** 2).sum().backward()
    assert heads == []
    w = est.predict_flow.weight.grad
    assert w is not None and torch.isfinite(w).all() and w.abs().sum() > 0
    torch.testing.assert_close(up.grad, 2 * flow.detach())


def _heads_of_chunks(monkeypatch, heads, owner, run):
    """The GEMM heads of each chunk of `clip_flow` in `run()`: calls of
    `conv3x3_to2` inside each call of `owner.estimate_flow_pairs`, the
    function `clip_flow` calls once a chunk."""
    per_chunk, real = [], owner.estimate_flow_pairs

    def chunk(*a, **kw):
        before = len(heads)
        out = real(*a, **kw)
        per_chunk.append(len(heads) - before)
        return out

    monkeypatch.setattr(owner, "estimate_flow_pairs", chunk)
    run()
    return per_chunk


def test_chunks_count_the_heads_of_pwcnet_and_none_of_raft(monkeypatch, heads):
    cfg = tcfg.Config(flow=tcfg.FlowConfig(compute_dtype="float32"),
                      render=tcfg.RenderConfig(kernel_impl="xla"))
    params = init_params(0, cfg.flow, "cpu")
    clip = make_shaky_clip(t=10, h=64, w=96, seed=0)[0]
    got = _heads_of_chunks(monkeypatch, heads, pipeline,
                           lambda: vstab_torch.stabilize(clip, params, cfg, device="cpu"))
    assert got == [6, 6]  # 9 pairs: two chunks, 5 predict_flow + 1 predict_res each

    rcfg = tcfg.Config(flow=tcfg.RaftConfig(iters=1, compute_dtype="float32"),
                       render=cfg.render)
    rparams = raft.init_params(0, rcfg.flow, "cpu")
    got = _heads_of_chunks(monkeypatch, heads, raft,
                           lambda: vstab_torch.stabilize(clip[:3], rparams, rcfg, device="cpu"))
    assert got == [0]


def test_a_training_step_takes_no_gemm_head(heads):
    flow_cfg = tcfg.FlowConfig(pyramid_channels=(8, 12, 16), estimator_channels=(16, 12),
                               compute_dtype="float32", output_level=1)
    net = build_net(init_params(0, flow_cfg, "cpu"), flow_cfg)
    opt = ttrain.make_optimizer(net.parameters(), lr=1e-4)
    step = ttrain.make_train_step(net, opt, "supervised", ttrain.cosine_schedule(opt, 10, 0.02))
    batch = ttrain._sample_batch(torch.Generator().manual_seed(0), torch.rand(4, 64, 64, 3), 2, 4.0)
    step(batch)
    assert heads == []
