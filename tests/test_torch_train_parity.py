"""vstab_torch's trainer held to the JAX package's own steps on the CPU, at
full width (the default FlowConfig, f32, batch 8 at 192x256), through
`vstab_torch.eval.quality`.

The reference is `tests/torch_train_reference.json` and the draws in the npz
beside it, written by the JAX package (`tests/torch_train_reference.py`):
500 steps of the recipe that made `flow_082000` from `flow_074000`, a twin
of them from perturbed parameters, the draws of every step, the held-out
pairs and the EPEs on them. The card replays all 500 steps
(`chip_smoke.py`'s train parity phase); here the first 20.

Tolerances: the pools as `quality.check_clips` holds clips (sum to 1e-6 a
value, 64 kept values to 1e-5); batches rebuilt from the kept draws against
the JAX package's `_sample_batch` under the same key 1e-4 (as
`test_torch_train.py`: a chain of resize, warp and blends on values up to
about 30 px); each replayed step's metrics within the reference's own
per-step tolerance (3 times how far its twin parted, at least 1e-4 of the
value); `flow_074000`'s EPE on the held-out pairs 1e-3 px of the JAX
package's.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstab.flow.train as jtrain
from vstab_torch.eval import quality
from vstab_torch.flow import train as ttrain
from vstab_torch.utils.checkpoint import load_params, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = quality.load_train_reference(os.path.join(REPO, "tests", "torch_train_reference.json"))
RECIPES = REF["settings"]["recipes"]
HELD = REF["settings"]["held_out"]
CPU_STEPS = 20
THREADS = 4  # full-width steps and flows: about 2 s a step here against 6 on one thread


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """THREADS torch threads while this file runs (the other torch test files
    pin one when they are imported), then the setting it found."""
    was = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(was)


def _pool_args(name):
    """(n, seed, kinds) of a pool of the reference, by its name there."""
    if name.startswith("held/"):
        return 8, HELD["seed"], HELD["sets"][name[5:]][0]
    r = RECIPES[name]
    return r["n_scenes"], r["pool_seed"], r["kinds"]


@functools.lru_cache(maxsize=None)
def _pool(name):
    return quality.reference_pool(REF, name, *_pool_args(name))


@functools.lru_cache(maxsize=None)
def _start():
    return params_from_jax(load_params(os.path.join(REPO, RECIPES["replay"]["start"])))


def test_reference_is_whole():
    k = RECIPES["replay"]["steps"]
    assert REF["partial"] is False and k == 500
    for part in ("replay", "twin", "tolerance"):
        assert all(len(REF[part][m]) == k for m in quality.TRAIN_METRICS)
    assert REF["arrays"]["replay/idx"].shape == (k, 8)
    assert REF["arrays"]["replay/occ_move"].shape == (k, 3, 8, 2)
    assert REF["arrays"]["warm_start/coarse"].shape == (RECIPES["warm_start"]["steps"], 8, 4, 5, 2)
    # the jitted step stands in for train_fast's scan: the same computation
    assert REF["train_fast_check"]["passes"]


def test_tolerance_follows_its_rule():
    for m in quality.TRAIN_METRICS:
        replay, twin = np.asarray(REF["replay"][m]), np.asarray(REF["twin"][m])
        want = np.maximum(3.0 * np.maximum.accumulate(np.abs(twin - replay)), 1e-4 * np.abs(replay))
        np.testing.assert_allclose(REF["tolerance"][m], want, rtol=1e-12, atol=0)
    for name, tol in REF["epe_tolerance"].items():
        d = REF["held_out"]["twin_end"][name]["mean_px"] - REF["held_out"]["replay_end"][name]["mean_px"]
        assert tol == pytest.approx(max(3.0 * abs(d), 0.01), rel=1e-12)


@pytest.mark.parametrize("name", sorted(REF["pools"]))
def test_scene_pool_is_the_reference_s(name):
    """The port's numpy generator draws the pools the JAX package trained and
    scored on (`reference_pool` raises otherwise)."""
    pool = _pool(name)
    assert pool.shape == tuple(REF["pools"][name]["shape"]) and pool.dtype == np.float32


def _jax_key(prefix, k):
    """The key the JAX package's `_sample_batch` got for step (or held-out batch) k."""
    if prefix.startswith("held/"):
        return jax.random.fold_in(jax.random.PRNGKey(HELD["seed"]), k)
    rng = jax.random.PRNGKey(RECIPES[prefix]["key_seed"])
    for _ in range(k + 1):
        rng, sub = jax.random.split(rng)
    return sub


@pytest.mark.parametrize("prefix,k", [("replay", 0), ("replay", 1), ("held/occluders", 0)])
def test_batch_from_kept_draws_matches_jax_sample_batch(prefix, k):
    held = prefix.startswith("held/")
    occluders = HELD["sets"][prefix[5:]][1] if held else True
    scenes, max_disp = _pool(prefix), REF["settings"]["max_disp"]
    want = jtrain._sample_batch(_jax_key(prefix, k), jnp.asarray(scenes), 8, max_disp, blur=not held,
                                occluders=occluders)
    draws = quality.draws_at(quality.reference_draws(REF, prefix, "cpu"), k)
    assert len(draws["occluders"]) == (3 if occluders else 0)
    got = ttrain._batch_from_draws(torch.from_numpy(scenes), draws, max_disp, blur=not held)
    for key in ("im1", "im2", "flow"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def replayed():
    hist, _ = quality.replay(REF, _start(), steps=CPU_STEPS, device="cpu")
    return hist


@pytest.mark.parametrize("metric", quality.TRAIN_METRICS)
def test_first_steps_within_the_reference_s_tolerance(replayed, metric):
    row = quality.hold_steps(REF, replayed)[metric]
    assert row["steps"] == CPU_STEPS
    assert row["ok"], row


@pytest.mark.parametrize("name", sorted(HELD["sets"]))
def test_held_out_epe_of_the_start_matches_jax(name):
    got = quality.held_out_epe(REF, _start(), sets=[name], device="cpu")[name]
    want = REF["held_out"]["flow_074000"][name]
    assert len(got["per_batch_px"]) == HELD["n"] // 8
    assert abs(got["mean_px"] - want["mean_px"]) <= 1e-3
