"""The RAFT cell's harness on the CPU: its reference's weights, its counts, and whole runs of the driver at a small size
(published widths, the configuration's seeded weights, two 9x64x96 clips):
a sound run comes out correct under the cell's limits, and a run with the
timed path broken underneath comes out not correct, once for each fault."""

import dataclasses
import time

import pytest
import torch

from h100bench import harness
from h100bench.counts import raft as counts
from h100bench.reference import raft as ref_raft
from h100bench.tests import helpers

torch.set_num_threads(4)
CPU = torch.device("cpu")
CELL = "stab_720p_raft"


def test_reference_weights_have_the_programs_names_and_shapes():
    from vstab_torch.flow import raft

    p = ref_raft.init_params(2020, CPU)
    q = raft.init_params(0, device="cpu")
    assert set(p) == set(q) and all(p[k].shape == q[k].shape for k in q)
    assert torch.equal(p["cnet.norm1.running_var"], torch.ones(64))


def test_clip_ops_at_720p():
    """The clip's operations from RAFT's layer shapes: encoders 11.9,
    correlation 5.0, updates 72.5, mask 0.6 TFLOP a 48-frame 720p clip."""
    flow = harness.Cell.find(CELL).config["program"]["flow"]
    ops = counts.clip_ops(48, 720, 1280, flow)
    assert ops["float32"] == pytest.approx(47 * 2 * 256 * 14400**2)
    assert counts.update_ops_per_pixel(flow) == pytest.approx(5_351_936)
    assert ops["bfloat16"] / 1e12 == pytest.approx(11.9 + 72.5 + 0.6, abs=0.3)
    assert counts.least_s(ops) == pytest.approx(ops["bfloat16"] / 989e12 + ops["float32"] / 67e12)


def test_lookup_bytes_lie_between_the_rows_and_the_whole_windows():
    npix, levels, r = 8 * 90 * 160, 4, 4
    sizes = [90, 160, 45, 80, 22, 40, 11, 20]
    args = [0, 0, 0, 0, *sizes, levels, r, 0, 0, npix, 1, 0]
    out = npix * (8 + levels * 81 * 2)
    nbytes = counts.lookup_bytes(args)
    assert out < nbytes <= out + npix * levels * 100 * 4
    # away from the borders every window is whole: one pixel of a large level
    assert counts.lookup_bytes([0, 0, 0, 0, 50, 50, 0, 0, 0, 0, 0, 0, 1, 4, 0, 0, 2500, 0, 0]) \
        < 2500 * (100 * 4 + 8 + 81 * 4)


def _run(params=None):
    cell, _ = helpers.tiny_cell(CELL)
    run = harness.Run(cell=cell, seed=2**31 + 77, seconds=0.3, trace=False, device=CPU,
                      t_start=time.perf_counter(), params=params)
    return harness.driver(cell.spec["entry"]).run(run)


def _fewer_iterations(fn):
    """10 of the 20 recurrent updates."""
    def wrapped(p, frames, cfg):
        return fn(p, frames, dataclasses.replace(cfg, iters=cfg.iters // 2))
    return wrapped


def _radius_3(fn):
    """The lookup's window of radius 3, its outer ring of radius 4 left 0."""
    def wrapped(pyramid, coords, radius=4, out_dtype=torch.float32):
        small = fn(pyramid, coords, radius - 1, torch.float32)
        n, h, w, _ = small.shape
        k, levels = 2 * radius + 1, len(pyramid)
        out = torch.zeros((n, h, w, levels, k, k))
        out[..., 1:-1, 1:-1] = small.view(n, h, w, levels, k - 2, k - 2)
        return out.view(n, h, w, levels * k * k).to(out_dtype)
    return wrapped


def _altered(fn):
    """The first frame of a render comes out as it went in, unstabilized."""
    def wrapped(frames, *a, **k):
        out = fn(frames, *a, **k).clone()
        out[0] = frames[0]
        return out
    return wrapped


FAULTS = {
    "ten_of_twenty_iterations": ("vstab_torch.flow.raft.estimate_flow_pairs", _fewer_iterations),
    "radius_3": ("vstab_torch.flow.raft.corr_lookup", _radius_3),
    "answer_altered": ("vstab_torch.pipeline.render_stabilized", _altered),
}


def test_a_sound_run_is_correct():
    out = _run()
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    import importlib

    target, make = FAULTS[fault]
    mod_name, attr = target.rsplit(".", 1)
    owner = importlib.import_module(mod_name)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = _run()
    assert not out.correct, out.checks
