"""The GMFlow cell's harness on the CPU: its counts against a count of the
reference's own products, its reference's fp8 policy, the trace readers on
made-up traces, and whole runs of the driver at a small size (published
widths, the configuration's seeded weights, two 9x64x96 clips): a sound
run comes out correct under the cell's limits, and a run with the timed
path broken underneath comes out not correct, once for each fault."""

import importlib
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import harness
from h100bench.counts import gmflow as counts
from h100bench.reference import gmflow as ref_gmflow
from h100bench.reference import precision
from h100bench.tests import helpers

torch.set_num_threads(4)
CPU = torch.device("cpu")
CELL = "stab_720p_gmflow"


@pytest.mark.parametrize("hw", [(64, 96), (72, 100)])
def test_counts_match_a_count_of_the_references_products(hw):
    """torch's FlopCounterMode over the reference's forward of one pair (two
    backbones, every convolution, linear layer and matrix product) reads
    what the layer shapes give."""
    p = ref_gmflow.init_params(0, CPU)
    frames = torch.rand((2, *hw, 3), generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as fc:
        list(ref_gmflow.pair_flows(p, frames))
    assert fc.get_total_flops() == sum(counts.clip_ops(2, *hw).values())


def test_clip_ops_at_720p():
    """A 48-frame 720p clip: backbone 0.20 TFLOP a frame, the transformer
    2.26 TFLOP a pair (attention 1.33), matchings and propagations 0.119
    TFLOP a pair in float32; least 119 + 83 ms at the H100's peaks."""
    assert counts.grid(720, 1280, 8) == (92, 160) and counts.grid(720, 1280, 4) == (184, 320)
    assert counts.backbone_ops(720, 1280) / 1e12 == pytest.approx(0.2006, abs=1e-4)
    tr = counts.transformer_ops(720, 1280, 8, 2) + counts.transformer_ops(720, 1280, 4, 8)
    assert tr / 1e12 == pytest.approx(2.257, abs=1e-3)
    assert counts.attention_ops(720, 1280, 8, 2) == counts.attention_ops(720, 1280, 4, 8) == pytest.approx(665.6e9,
                                                                                                         rel=1e-4)
    pair = counts.pair_ops(720, 1280)
    assert pair["float32"] / 1e12 == pytest.approx(0.1189, abs=1e-4)
    ops = counts.clip_ops(48, 720, 1280)
    assert ops["float32"] == 47 * pair["float32"]
    assert counts.least_s(ops) == pytest.approx(ops["bfloat16"] / 989e12 + ops["float32"] / 67e12)
    assert counts.least_s(ops) == pytest.approx(0.2023, abs=1e-3)


def test_the_programs_span_counts_are_the_counts():
    """The flops the program's spans carry for a 720p chunk of 8 pairs are
    8 pairs' worth of `counts/gmflow.py`."""
    from vstab_torch.flow import gmflow

    assert gmflow.attn_flops(8, 92, 160, 2) == 8 * counts.attention_ops(720, 1280, 8, 2)
    assert gmflow.attn_flops(8, 184, 320, 8) == 8 * counts.attention_ops(720, 1280, 4, 8)
    assert gmflow.match_flops(8, 92, 160, -1) == 8 * counts.match_ops(720, 1280, 8, -1)
    assert gmflow.match_flops(8, 184, 320, 4) == 8 * counts.match_ops(720, 1280, 4, 4)
    assert gmflow.propagate_flops(8, 92, 160, -1) == 8 * counts.propagate_ops(720, 1280, 8, -1)
    assert gmflow.propagate_flops(8, 184, 320, 1) == 8 * counts.propagate_ops(720, 1280, 4, 1)


def test_reference_weights_are_the_programs():
    from vstab_torch.flow import gmflow

    p, q = ref_gmflow.init_params(2022, CPU), gmflow.init_params(2022, device="cpu")
    assert list(p) == list(q) and all(torch.equal(p[k], q[k]) for k in q)


def test_fp8_policy_rounds_every_bfloat16_operand_and_nothing_else(monkeypatch):
    """Under "fp8" the reference rounds both operands of each of a frame's 17
    convolutions (34 a frame), of each block's 8 projections, 2 FFN layers
    and 2 attention products (28 a block, 168 a scale), and of the
    upsampler's 2 convolutions: 68 + 336 + 4 for one pair. The matchings
    and propagations round nothing, and the flow moves."""
    rounded = []
    real = precision.fp8_round
    monkeypatch.setattr(precision, "fp8_round", lambda x: rounded.append(x.shape) or real(x))
    p = ref_gmflow.init_params(0, CPU, norm_gain=0.1, feature_scale=0.15)
    frames = torch.rand((2, 64, 96, 3), generator=torch.Generator().manual_seed(2))
    got = next(ref_gmflow.pair_flows(p, frames, "fp8"))
    assert len(rounded) == 68 + 336 + 4
    assert not any(s[-1] == 2 for s in rounded)  # no flow, no coordinates
    rounded.clear()
    want = next(ref_gmflow.pair_flows(p, frames, "f32"))
    assert not rounded and float((got - want).abs().mean()) > 0.05  # px; 0.096 on this pair


def _trace_file(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_attention_device_time_is_read_by_the_launches_correlation(tmp_path):
    from h100bench.drivers import stabilize_gmflow as drv

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("user_annotation", "vstab.flow.gmflow.transformer", 0, 100),
        x("cpu_op", "aten::scaled_dot_product_attention", 10, 5),
        x("cuda_runtime", "cudaLaunchKernel", 12, 1, 1), x("kernel", "fmha_kernel", 200, 30, 1),
        x("cuda_runtime", "cudaLaunchKernel", 20, 1, 2), x("kernel", "gemm_bf16", 240, 40, 2),  # a projection
        x("user_annotation", "vstab.flow.gmflow.match", 100, 50),
        x("cuda_driver", "cuLaunchKernel", 110, 1, 3), x("kernel", "sgemm", 300, 70, 3),
        x("cuda_runtime", "cudaLaunchKernel", 120, 1, 4), x("kernel", "softmax", 380, 9, 4),
        x("user_annotation", "vstab.flow.gmflow.upsample", 160, 20),
        x("cuda_runtime", "cudaLaunchKernel", 165, 1, 5), x("kernel", "conv", 400, 11, 5),
    ]
    assert drv.attention_device_s(_trace_file(tmp_path, events)) == (pytest.approx(109e-6), 3)


def test_chunk_spans_sum_by_chunk():
    from h100bench.drivers import stabilize_gmflow as drv

    def rec(name, parent, ms):
        return {"name": drv.SPAN + name, "parent": parent, "device_ms": ms, "attrs": {}}

    records = [rec("encode", 1, 5.0), rec("transformer", 1, 10.0), rec("transformer", 1, 12.0),
               rec("match", 1, 3.0), rec("propagate", 1, 1.0), rec("match", 1, 2.0), rec("propagate", 1, 0.5),
               rec("encode", 2, 6.0), rec("transformer", 2, 20.0), rec("match", 2, 1.0), rec("upsample", 2, 9.0)]
    assert drv.chunk_ms(records) == {"encode": [5.0, 6.0], "transformer": [22.0, 20.0], "match": [6.5, 1.0]}
    ctx = {"profile": {"chunk_ms": drv.chunk_ms(records)}}
    for name, want in (("gmflow_encode_ms.gmflow", 5.5), ("gmflow_transformer_ms.gmflow", 21.0),
                       ("gmflow_match_ms.gmflow", 3.75)):
        assert harness.metric_reader(name)(ctx) == pytest.approx(want)
        assert harness.metric_reader(name)({}) is None and harness.metric_reader(name)(None) is None
    roof = harness.metric_reader("attn_roofline.gmflow")
    assert roof({"profile": {"attn_bound_s": 0.02, "attn_device_s": 0.05}}) == pytest.approx(40.0)
    assert roof({"profile": {"attn_bound_s": 0.02, "attn_device_s": 0.0}}) is None and roof({}) is None


def _run(trace=False, params=None):
    cell, _ = helpers.tiny_cell(CELL)
    run = harness.Run(cell=cell, seed=2**31 + 77, seconds=0.3, trace=trace, device=CPU,
                      t_start=time.perf_counter(), params=params)
    return run, harness.driver(cell.spec["entry"]).run(run)


def test_a_traced_run_reports_what_the_cpu_can_read():
    """Without a card nothing is profiled: the traced line holds the harness's
    stage times and mfu.gmflow, and no device metric."""
    run, out = _run(trace=True)
    line = harness.result_line(run, out, {"platform": "cpu"})
    assert set(line["metrics"]) == {"flow_ms.720p", "smooth_ms.720p", "render_ms.720p", "mfu.gmflow"}
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["checks"]) == {"step_mean_px", "path_mean_px", "frame_median", "frame_mad"}


def _five_of_six_blocks(fn):
    """The transformer stops after 5 of its 6 blocks."""
    def wrapped(p, f0, f1, splits, blocks=6):
        return fn(p, f0, f1, splits, blocks - 1)
    return wrapped


def _radius_3(fn):
    """The local matching searches a radius of 3, not 4."""
    def wrapped(f0, f1, radius):
        return fn(f0, f1, radius - 1)
    return wrapped


def _unmasked(fn):
    """The shifted windows attend across their regions (no Swin mask)."""
    def wrapped(q, k, v, splits, mask=None):
        return fn(q, k, v, splits, None)
    return wrapped


def _altered(fn):
    """The first frame of a render comes out as it went in, unstabilized."""
    def wrapped(frames, *a, **k):
        out = fn(frames, *a, **k).clone()
        out[0] = frames[0]
        return out
    return wrapped


FAULTS = {
    "five_of_six_blocks": ("vstab_torch.flow.gmflow.transformer", _five_of_six_blocks),
    "radius_3": ("vstab_torch.flow.gmflow.local_match", _radius_3),
    "no_swin_mask": ("vstab_torch.flow.gmflow.window_attention", _unmasked),
    "answer_altered": ("vstab_torch.pipeline.render_stabilized", _altered),
}


def test_a_sound_run_is_correct():
    _, out = _run()
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    target, make = FAULTS[fault]
    mod_name, attr = target.rsplit(".", 1)
    owner = importlib.import_module(mod_name)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    _, out = _run()
    assert not out.correct, out.checks
