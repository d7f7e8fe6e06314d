"""The profiler trace reader on a chrome trace written here."""

import json

import pytest

from h100bench import trace_read


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur}


@pytest.fixture
def trace(tmp_path):
    events = [
        _ev("user_annotation", "h100bench.window", 0.0, 100.0),
        _ev("user_annotation", "render", 5.0, 90.0),
        _ev("kernel", "void vstab::cost_volume_mma_kernel<1>(...)", 0.0, 10.0),
        _ev("kernel", "void vstab::cost_volume_mma_kernel<1>(...)", 5.0, 10.0),  # overlaps
        _ev("cpu_op", "aten::item", 15.0, 20.0),
        _ev("cuda_runtime", "cudaStreamSynchronize", 16.0, 18.0),
        _ev("kernel", "sm90_xmma_conv", 40.0, 22.0),
        _ev("gpu_memcpy", "Memcpy DtoH", 60.0, 5.0),
        _ev("cpu_op", "aten::cat", 70.0, 25.0),
        _ev("kernel", "void vstab::hwarp_row_kernel(...)", 95.0, 3.0),
        {"ph": "i", "name": "marker", "ts": 1.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_busy_idle_and_names(trace):
    s = trace_read.summarize(trace, window=(0.0, 100.0))
    # busy: [0, 15] + [40, 65] + [95, 98] = 43 us
    assert s["busy_s"] == pytest.approx(43e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["by_name"]["void vstab::cost_volume_mma_kernel<1>(...)"] == [pytest.approx(20e-6), 2]
    assert s["device_ops"][0] == ["sm90_xmma_conv", pytest.approx(22e-6)]
    gaps = s["idle_gaps"]
    assert [round(g[1] * 1e6, 6) for g in gaps] == [30.0, 25.0, 2.0]
    # the innermost host event that covers most of each gap, after the span around it
    assert gaps[0][0] == "render / aten::cat"  # [65, 95]
    assert gaps[1][0] == "render / cudaStreamSynchronize"  # [15, 40], inside aten::item
    assert gaps[2][0] == "h100bench.window"


def test_the_window_defaults_to_the_events_extent(trace):
    assert trace_read.summarize(trace)["window_s"] == pytest.approx(100e-6)


def test_no_device_event_gives_nothing(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [_ev("cpu_op", "aten::add", 0.0, 5.0)]}))
    assert trace_read.summarize(str(p)) is None


def test_a_cpu_profile_records_no_device_time(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    assert trace_read.summarize(str(tmp_path / "cpu.json")) is None
