"""Whole runs of each entry on the CPU at small sizes (the published widths,
the cells' checkpoints, a few small clips or scenes), skipping only the
look for a card: a sound run comes out correct under the cells' limits, and
a run with the timed path broken underneath comes out not correct, once for
each fault the cell can have."""

import time

import pytest
import torch

from h100bench import harness
from h100bench.tests import helpers

torch.set_num_threads(4)
CPU = torch.device("cpu")


def _run(name, seed=2**31 + 77):
    cell, params = helpers.tiny_cell(name)
    run = harness.Run(cell=cell, seed=seed, seconds=0.3, trace=False, device=CPU,
                      t_start=time.perf_counter(), params=params)
    return harness.driver(cell.spec["entry"]).run(run)


def _altered(fn):
    """An answer altered where it is produced: the first frame of a render
    comes out as it went in, unstabilized."""
    def wrapped(frames, *a, **k):
        out = fn(frames, *a, **k).clone()
        out[0] = frames[0]
        return out
    return wrapped


def _region_altered(fn):
    """An answer altered where it is produced in part of every frame: the
    top quarter of each rendered frame comes out brighter."""
    def wrapped(frames, *a, **k):
        out = fn(frames, *a, **k).clone()
        out[:, : out.shape[1] // 4] += 0.25
        return out
    return wrapped


def _half_pairs(fn):
    """Half of each chunk of pairs left out: their flow comes back zero."""
    def wrapped(params, frames, cfg):
        flow = fn(params, frames, cfg).clone()
        flow[: flow.shape[0] // 2] = 0.0
        return flow
    return wrapped


def _half_batch(fn):
    """The loss's mean taken over half of the batch."""
    def wrapped(pyr, gt):
        n = gt.shape[0] // 2
        return fn([p[:n] for p in pyr], gt[:n])
    return wrapped


def _unchanged_step(self):
    """A step that leaves the state unchanged (the norm is still reported)."""
    grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
    self.grad_norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))


FAULTS = {
    "stab_720p_whole": {
        "answer_altered": ("vstab_torch.pipeline.render_stabilized", _altered),
        "region_altered": ("vstab_torch.pipeline.render_stabilized", _region_altered),
        "half_batch": ("vstab_torch.pipeline.estimate_flow_pairs", _half_pairs),
    },
    "stab_1080p_blocked": {
        "answer_altered": ("vstab_torch.pipeline_blocked.render_stabilized", _altered),
        "region_altered": ("vstab_torch.pipeline_blocked.render_stabilized", _region_altered),
        "half_batch": ("vstab_torch.pipeline.estimate_flow_pairs", _half_pairs),
    },
    "train_192x256_b8": {
        "half_batch": ("vstab_torch.flow.train.multiscale_epe", _half_batch),
        "state_unchanged": ("vstab_torch.flow.train.ClippedAdamW.step", lambda fn: _unchanged_step),
    },
}


@pytest.mark.parametrize("name", list(FAULTS))
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0


@pytest.mark.parametrize("name,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_broken_run_is_not_correct(name, fault, monkeypatch):
    import importlib

    target, make = FAULTS[name][fault]
    mod_name, attr = target.rsplit(".", 1)
    try:
        owner = importlib.import_module(mod_name)
    except ModuleNotFoundError:  # a method: module.Class.method
        mod_name, cls = mod_name.rsplit(".", 1)
        owner = getattr(importlib.import_module(mod_name), cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = _run(name)
    assert not out.correct, out.checks
