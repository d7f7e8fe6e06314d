"""vstab_torch's spans (`vstab_torch/utils/trace.py`) on the CPU: off they
record nothing, on they nest under one root per clip, blocked call or
training step, the blocked pipeline's stats are made from them, and under
`torch.profiler` they sit in the chrome trace with the same names and
durations.
"""

import json
import tracemalloc

import numpy as np
import pytest
import torch

import vstab_torch
from vstab_torch.core import config as tcfg
from vstab_torch.eval.synthetic import make_shaky_clip
from vstab_torch.flow import train as ttrain
from vstab_torch.flow.pwcnet import build_net, init_params
from vstab_torch.pipeline import default_params
from vstab_torch.render.render import pick_max_disp
from vstab_torch.utils import trace

torch.set_num_threads(1)

_TINY = dict(
    pyramid_channels=(8, 12, 16), estimator_channels=(16, 12),
    kernel_impl="xla", compute_dtype="float32", output_level=1,
)
_STAGES = ("vstab.flow", "vstab.smooth", "vstab.bucket", "vstab.warp_field", "vstab.render")
_HOST_KEYS = {"prefetch_wait", "staging_wait", "stage_copy", "dispatch", "pinned_alloc",
              "fetch_wait", "drain_copy", "out_wait"}


@pytest.fixture(scope="module")
def cfg():
    return tcfg.Config(flow=tcfg.FlowConfig(**_TINY),
                       render=tcfg.RenderConfig(kernel_impl="xla"))


@pytest.fixture(scope="module")
def params(cfg):
    return default_params(cfg, seed=0, ckpt_dir="/nonexistent", device="cpu")


@pytest.fixture(scope="module")
def clip():
    return make_shaky_clip(t=9, h=64, w=96, seed=0)[0]


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_a_span_records_nothing_and_is_one_shared_object(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span made a CUDA event or a profiler range while off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(trace._profiler, "record_function", refuse)
    first = trace.span("vstab.a")
    assert trace.span("vstab.b", device=True) is first
    assert trace.span("vstab.c", t=3) is first

    def loop(n):
        for _ in range(n):
            with trace.span("vstab.a") as s:
                s.set(x=1)
            with trace.span("vstab.b", device=True):
                pass

    loop(100)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        loop(20_000)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024  # nothing kept a call
    assert trace.records() == [] and trace.dropped() == 0


def test_off_a_span_with_into_adds_its_self_seconds():
    into, other = {}, {}
    with trace.span("vstab.blocked.outer", into=into):
        with trace.span("vstab.blocked.inner", into=into):
            sum(range(20_000))
        with trace.span("vstab.elsewhere.sweep", into=other):  # another dict: not subtracted
            sum(range(20_000))
    assert set(into) == {"outer", "inner"} and set(other) == {"sweep"}
    assert into["outer"] > 0 and into["inner"] > 0 and other["sweep"] > 0
    assert into["outer"] >= other["sweep"] - 1e-6  # the other dict's span stays in outer's self time
    assert trace.records() == []


def test_stabilize_spans_nest_under_one_root(clip, params, cfg):
    with trace.recording():
        vstab_torch.stabilize(clip, params, cfg, device="cpu")
    recs = trace.records()
    names = _by_name(recs)
    (root,) = names["vstab.stabilize"]
    assert root["parent"] is None and root["attrs"] == {"t": 9, "h": 64, "w": 96}
    for name in _STAGES:
        assert len(names[name]) == 1, name
    chunks = names["vstab.flow.chunk"]
    assert len(chunks) == -(-8 // vstab_torch.pipeline.default_pair_chunk(64, 96))
    assert all(c["parent"] == names["vstab.flow"][0]["id"] for c in chunks)
    bucket = names["vstab.bucket"][0]["attrs"]
    assert set(bucket) == {"bound_px", "max_disp"}
    assert bucket["max_disp"] == pick_max_disp(bucket["bound_px"], cfg.render)
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        assert r["root"] == root["id"]
        assert r["device_ms"] is None  # nothing on the card here
        if r is not root:
            up = by_id[r["parent"]]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= up["end_ns"]


def test_stabilize_batch_spans_share_the_batch_root(clip, params, cfg):
    with trace.recording():
        vstab_torch.stabilize_batch(np.stack([clip, clip[::-1]]), params, cfg, device="cpu")
    recs = trace.records()
    names = _by_name(recs)
    (root,) = names["vstab.stabilize_batch"]
    assert root["attrs"] == {"b": 2, "t": 9, "h": 64, "w": 96}
    assert all(r["root"] == root["id"] for r in recs)
    assert {k: len(names[k]) for k in _STAGES} == {
        "vstab.flow": 2, "vstab.smooth": 2, "vstab.bucket": 1, "vstab.warp_field": 2, "vstab.render": 2}


def test_blocked_spans_nest_under_one_root(clip, params, cfg):
    with trace.recording():
        out = vstab_torch.stabilize_blocked(clip, params, cfg, block_len=4, device="cpu")
    assert out.shape == clip.shape
    recs = trace.records()
    names = _by_name(recs)
    (root,) = names["vstab.blocked"]
    assert root["attrs"] == {"t": 9, "block_len": 4}
    assert all(r["root"] == root["id"] for r in recs)
    for k in ("motion_sweep", "solve", "scale_sweep", "render_sweep"):
        (r,) = names[f"vstab.blocked.{k}"]
        assert r["parent"] == root["id"]
    # three motion blocks and three render blocks, each staged and dispatched
    assert len(names["vstab.blocked.dispatch"]) == 6 and len(names["vstab.blocked.stage_copy"]) == 6
    assert len(names["vstab.flow"]) == 3 and len(names["vstab.render"]) == 3


def test_blocked_stage_s_is_the_sweep_spans_at_their_rounding(clip, params, cfg, caplog):
    caplog.set_level("INFO", logger="vstab_torch.blocked")
    with trace.recording():
        stats = vstab_torch.pipeline_blocked._run_blocked(
            lambda: ((clip[i : i + 4], i) for i in range(0, 9, 4)),
            lambda blk, start: None, 9, params, cfg, 4, torch.device("cpu"),
        )
    names = _by_name(trace.records())
    s = {k: names[f"vstab.blocked.{k}"][0]["host_ms"] / 1e3 for k in
         ("motion_sweep", "solve", "scale_sweep", "render_sweep")}
    assert stats["stage_s"] == {
        "flow": round(s["motion_sweep"], 3),
        "scale": round(s["solve"] + s["scale_sweep"], 3),
        "render": round(s["render_sweep"], 3),
    }
    assert stats["wall_s"] == round(names["vstab.blocked"][0]["host_ms"] / 1e3, 3)
    assert set(stats["host_s"]) == _HOST_KEYS
    assert all(v >= 0 for v in stats["host_s"].values())
    assert stats["host_s"]["dispatch"] > 0 and stats["host_s"]["stage_copy"] > 0
    assert sum(stats["host_s"].values()) <= s["motion_sweep"] + s["render_sweep"] + 7e-6
    # each key is the self time of its spans: their durations less the nested ones'
    for key in ("dispatch", "stage_copy", "prefetch_wait", "drain_copy"):
        spans = names[f"vstab.blocked.{key}"]
        ids = {r["id"] for r in spans}
        nested = sum(r["host_ms"] for r in trace.records()
                     if r["parent"] in ids and r["name"].rpartition(".")[2] in _HOST_KEYS)
        assert stats["host_s"][key] == pytest.approx(
            (sum(r["host_ms"] for r in spans) - nested) / 1e3, abs=1e-6)
    assert "blocked stabilize: " in caplog.text and "motion block 1/3" in caplog.text
    assert {r.msg.split()[0] for r in caplog.records if " block " in str(r.msg)} == {"motion", "render"}


def test_one_train_step_has_its_three_phases(cfg):
    flow_cfg = cfg.flow
    net = build_net(init_params(0, flow_cfg, "cpu"), flow_cfg)
    opt = ttrain.make_optimizer(net.parameters(), lr=1e-4)
    step = ttrain.make_train_step(net, opt, "supervised", ttrain.cosine_schedule(opt, 10, 0.02))
    with trace.recording():
        batch = ttrain._sample_batch(torch.Generator().manual_seed(0),
                                     torch.rand(4, 64, 64, 3), 2, 4.0)
        step(batch)
    names = _by_name(trace.records())
    (root,) = names["vstab.train.step"]
    assert len(names["vstab.train.batch"]) == 1 and names["vstab.train.batch"][0]["parent"] is None
    for phase in ("forward", "backward", "optimizer"):
        (r,) = names[f"vstab.train.{phase}"]
        assert r["parent"] == root["id"] and r["root"] == root["id"]
    starts = [names[f"vstab.train.{p}"][0]["start_ns"] for p in ("forward", "backward", "optimizer")]
    assert starts == sorted(starts)


def test_profiler_trace_holds_the_recorded_spans(clip, params, cfg, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vstab_torch.stabilize(clip, params, cfg, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    recs = trace.records()
    assert {r["name"] for r in recs} >= {"vstab.stabilize", "vstab.flow.chunk", *_STAGES}
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("vstab.")]
    want = _by_name(recs)
    got = {}
    for e in sorted(events, key=lambda e: float(e["ts"])):
        got.setdefault(e["name"], []).append(float(e["dur"]) / 1e3)
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    for name, rs in want.items():
        for r, ms in zip(sorted(rs, key=lambda r: r["start_ns"]), got[name]):
            assert abs(r["host_ms"] - ms) <= max(0.1 * ms, 0.2), name
