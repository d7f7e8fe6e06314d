"""The RAFT training cell's harness on the CPU: its counts, its readers, and
whole runs of its driver at a small size (published widths, the
configuration's seeded weights, batch 2 at 64x64): a sound run comes out
correct under the cell's limits, and a run with the trained path broken
underneath comes out not correct, once for each fault."""

import time

import pytest
import torch

from h100bench import harness, step_spans
from h100bench.control_raft_train import FAULTS, planted
from h100bench.counts import raft_train as counts
from h100bench.tests import helpers

torch.set_num_threads(4)
CPU = torch.device("cpu")
CELL = "train_raft_chairs"


def test_step_ops_at_the_chairs_size():
    """A pair's forward: three encoders 74.4, the correlation 4.2 and 12
    iterations of 17.8 GFLOP (update 15.3, mask head 2.5); a step of 10
    pairs 3 x that, 8.76 TFLOP, 131 ms at 67 TFLOP/s."""
    flow = harness.Cell.find(CELL).config["program"]["flow"]
    assert counts.forward_ops(368, 496, flow) / 1e9 == pytest.approx(292.03, abs=0.01)
    assert counts.step_ops(10, 368, 496, flow) == pytest.approx(30 * counts.forward_ops(368, 496, flow))


def test_lookup_bwd_bytes_by_hand():
    args = [0] * 4 + [46, 62, 23, 31, 11, 15, 5, 7] + [4, 4, 0, 0, 28_520, 0]
    assert counts.lookup_bwd_bytes(args) == 28_520 * (4 * 81 * 4 + 8 + 4 * 100 * 4)
    assert counts.lookup_bwd_bound_s(args) == pytest.approx(82.82e6 / 3.35e12, rel=1e-3)


def test_step_span_sums_read_nothing_without_a_profile():
    assert step_spans.per_step_ms({}, "vstab.flow.raft.upsample") is None
    assert step_spans.per_step_ms({"profile": {"busy_s": 1.0}}, "no.such.span") is None


def test_step_span_sums_group_spans_by_the_step_they_began_in(monkeypatch):
    from vstab_torch.utils import trace

    recs = [{"name": "vstab.train.step", "start_ns": 0, "end_ns": 100, "device_ms": 5.0},
            {"name": "vstab.train.step", "start_ns": 200, "end_ns": 300, "device_ms": 5.0},
            {"name": "x", "start_ns": 10, "end_ns": 20, "device_ms": 1.0},
            {"name": "x", "start_ns": 30, "end_ns": 40, "device_ms": 2.0},
            {"name": "x", "start_ns": 250, "end_ns": 260, "device_ms": 4.0},
            {"name": "x", "start_ns": 150, "end_ns": 160, "device_ms": 100.0}]
    monkeypatch.setattr(trace, "records", lambda: recs)
    assert step_spans.per_step_ms({"profile": {"busy_s": 1.0}}, "x") == pytest.approx(3.5)


def _run(seed=2**31 + 77):
    cell, _ = helpers.tiny_cell(CELL)
    run = harness.Run(cell=cell, seed=seed, seconds=0.3, trace=False, device=CPU,
                      t_start=time.perf_counter())
    return harness.driver(cell.spec["entry"]).run(run)


def test_a_sound_run_is_correct():
    out = _run()
    assert out.correct, out.checks
    assert out.attempted >= 2 and out.failed == 0
    assert set(out.e2e) == {"train_steps_per_s", "setup_s"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_run_is_not_correct(fault):
    with planted(fault):
        out = _run()
    assert not out.correct, out.checks


def test_the_parent_program_fails_at_once(monkeypatch):
    """A program without RAFT's training pass stops before any work."""
    import vstab_torch.flow.raft as raft

    monkeypatch.delattr(raft, "train_forward")
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        _run()
    assert time.perf_counter() - t0 < 5.0
