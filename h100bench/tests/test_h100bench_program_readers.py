"""The readers of the program's own records (`program_readers.py`) on
made-up contexts, on the parent's stats (no `host_s`) and on an empty span
buffer."""

import pytest

from h100bench import harness
from vstab_torch.utils import trace

BLOCKED = ("host_wait_ms_per_frame.blocked", "host_copy_ms_per_frame.blocked",
           "dispatch_ms_per_frame.blocked", "pinned_alloc_ms_per_frame.blocked",
           "pinned_mb_per_frame.blocked")
TRAIN = {"forward_gpu_ms.train": "forward", "backward_gpu_ms.train": "backward",
         "optimizer_gpu_ms.train": "optimizer"}


def _stats(frames, **host):
    s = dict.fromkeys(("prefetch_wait", "staging_wait", "stage_copy", "dispatch", "pinned_alloc",
                       "fetch_wait", "drain_copy"), 0.0)
    s.update(host)
    return {"frames": frames, "stage_s": {"flow": 1.0, "scale": 0.1, "render": 1.0},
            "host_s": s, "pinned_bytes": 31_200_000 * frames}


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def test_the_eight_metrics_are_entries_of_their_cells():
    per_layer = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in BLOCKED:
        assert per_layer[name]["workloads"] == ["stab_1080p_blocked"]
        assert per_layer[name]["moves"] == "blocked_frames_per_s"
    for name in TRAIN:
        assert per_layer[name]["workloads"] == ["train_192x256_b8"]
        assert per_layer[name]["moves"] == "train_steps_per_s"


def test_blocked_readers_sum_over_the_window_and_divide_by_its_frames():
    ctx = {"blocked_stats": [
        _stats(256, staging_wait=0.5, fetch_wait=1.0, stage_copy=0.25, drain_copy=0.75,
               dispatch=2.0, pinned_alloc=0.125),
        _stats(256, staging_wait=0.5, fetch_wait=0.0, stage_copy=0.25, drain_copy=0.25,
               dispatch=1.0, pinned_alloc=0.375),
    ]}
    read = {name: harness.metric_reader(name)(ctx) for name in BLOCKED}
    assert read["host_wait_ms_per_frame.blocked"] == pytest.approx(1e3 * 2.0 / 512)
    assert read["host_copy_ms_per_frame.blocked"] == pytest.approx(1e3 * 1.5 / 512)
    assert read["dispatch_ms_per_frame.blocked"] == pytest.approx(1e3 * 3.0 / 512)
    assert read["pinned_alloc_ms_per_frame.blocked"] == pytest.approx(1e3 * 0.5 / 512)
    assert read["pinned_mb_per_frame.blocked"] == pytest.approx(31.2)


def test_blocked_readers_read_nothing_from_stats_without_the_records():
    old = {"frames": 256, "stage_s": {"flow": 1.0, "scale": 0.1, "render": 1.0}}
    for name in BLOCKED:
        read = harness.metric_reader(name)
        assert read({"blocked_stats": [old]}) is None
        assert read({"blocked_stats": []}) is None


def test_train_readers_take_the_median_of_the_profiled_steps(monkeypatch):
    recs = []
    for i, ms in enumerate([30.0, 10.0, 20.0]):
        for phase, scale in (("forward", 1.0), ("backward", 2.0), ("optimizer", 0.5)):
            recs.append({"name": f"vstab.train.{phase}", "device_ms": ms * scale})
    recs.append({"name": "vstab.train.step", "device_ms": None})
    monkeypatch.setattr(trace, "records", lambda: recs)
    want = {"forward": 20.0, "backward": 40.0, "optimizer": 10.0}
    for name, phase in TRAIN.items():
        read = harness.metric_reader(name)
        assert read({"profile": {"busy_s": 1.0}}) == pytest.approx(want[phase])
        assert read({"spans": {"batch": [0.001]}}) is None  # no profiled section


def test_train_readers_read_nothing_from_an_empty_buffer():
    for name in TRAIN:
        assert harness.metric_reader(name)({"profile": {"busy_s": 1.0}}) is None


def test_train_readers_read_nothing_from_cpu_spans():
    """Spans recorded on the CPU carry no stream time: nothing to read."""
    with trace.recording():
        with trace.span("vstab.train.forward", device=False):
            pass
    assert harness.metric_reader("forward_gpu_ms.train")({"profile": {"busy_s": 1.0}}) is None
