"""Data parallelism of vstab_torch on the CPU: 2 and 4 gloo ranks.

Each world size is brought up once for the module, through
`vstab_torch.dist.initialize`, as processes running this file's `__main__`
block (they import torch, never JAX). The ranks run every case and write
their results under a temporary directory; the tests read them and hold
them against the port's one-process runs and the JAX package, computed here
while the ranks run.

The training step (`make_train_step(..., group=)`) on a global batch of 8
pairs at 64x64, split by rows, in both loss modes, 3 steps:
- the averaged gradients after the first step within 1e-5 of the largest
  |g| of the same step on one process on the whole batch, loss and
  grad_norm within 1e-5 relative (a convolution's weight gradient sums over
  the batch in another order, so they cannot be equal to the bit);
- the parameters after the first step within 2*lr + 1e-6 of the one
  process's: Adam's first step moves a weight by about lr*sign(g), so a
  gradient near 0 may move it up to 2*lr apart;
- the parameters after 3 steps equal to the bit on every rank, grad_norm
  equal on every rank;
- losses and grad_norm within 1e-3 relative of the JAX package's step with
  the same batch sharded over a mesh of as many CPU devices (the
  reference's multi-device dry run, part (a)), as the serial steps are held
  in `tests/test_torch_train.py`.

The sweep (`run_sweep(data_parallel=True)`) on 9 synthetic 9x48x64 clips:
every clip once, scores within 5e-3 of the port's serial sweep (the
reference's own tolerance in `tests/eval/test_dp_sweep.py`), held to the
port's serial sweep and not to the JAX package's scores, which spread by
hundredths on near-equal videos.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch_ranks import World

WORLDS = (2, 4)
MODES = ("supervised", "photometric")
BATCH, HW, STEPS, LR = 8, (64, 64), 3, 3e-4
N_CLIPS, CLIP = 9, (9, 48, 64)
_WORKER_TIMEOUT_S = 300

# tests/eval/test_dp_sweep.py's small network and sweep configuration
_FLOW = dict(pyramid_channels=(8, 12, 16), estimator_channels=(16, 12), kernel_impl="xla",
             compute_dtype="float32", output_level=1)
# __graft_entry__.py's `_tiny_flow_cfg`, the multi-device dry run's network
_DRY_FLOW = dict(pyramid_channels=(8, 16, 24), estimator_channels=(16, 16), context_dilations=(1, 2, 1),
                 search_radius=2, kernel_impl="xla", compute_dtype="float32", output_level=2)


def _sweep_cfg(mod):
    return mod.Config(
        flow=mod.FlowConfig(**_FLOW),
        smooth=mod.SmoothConfig(method="sparse_ls", grid_size=(4, 4)),
        render=mod.RenderConfig(crop_mode="fixed", kernel_impl="xla"),
    )


def _clip_names():
    return [f"synthetic_dyn_{i:03d}" if i % 3 == 2 else f"synthetic_{i:03d}" for i in range(N_CLIPS)]


def _global_batch(seed=0, max_disp=3.0):
    """Labeled pairs from a numpy seed: smooth random scenes warped by smooth
    random flows (as `tests/test_torch_train.py` makes them)."""
    from vstab_torch.flow import train as T
    from vstab_torch.kernels import bilinear_warp_plain

    rng = np.random.default_rng(seed)
    h, w = HW
    im1 = np.stack([T.make_scene_pool(1, h, w, seed=int(rng.integers(1 << 30)), kinds=("checker",))[0]
                    for _ in range(BATCH)])
    coarse = (rng.random((BATCH, 4, 5, 2)) * 2 - 1).astype(np.float32) * max_disp
    flow = T._resize_cubic(torch.from_numpy(coarse), HW)
    im2 = bilinear_warp_plain(torch.from_numpy(im1), flow)
    return {"im1": im1, "im2": im2.numpy(), "flow": flow.numpy()}


def _batch_for(mode, arrays, rows=slice(None)):
    keys = ("im1", "im2", "flow") if mode == "supervised" else ("im1", "im2")
    return {k: torch.from_numpy(np.ascontiguousarray(arrays[k][rows])) for k in keys}


def _run_steps(params, mode, batch, group=None):
    """STEPS steps from `params`: the metrics of each, the gradients and
    parameters after the first step and the parameters after the last."""
    from vstab_torch.core.config import FlowConfig
    from vstab_torch.flow import train as T
    from vstab_torch.flow.pwcnet import build_net

    net = build_net({k: v.clone() for k, v in params.items()}, FlowConfig(**_FLOW)).train()
    opt = T.make_optimizer(net.parameters(), LR)
    step = T.make_train_step(net, opt, mode, group=group)
    out, metrics = {}, []
    for i in range(STEPS):
        metrics.append({k: float(v) for k, v in step(batch).items()})
        if i == 0:
            for k, p in net.named_parameters():
                out[f"grad1/{k}"] = p.grad.numpy().copy()
                out[f"param1/{k}"] = p.detach().numpy().copy()
    for k, p in net.named_parameters():
        out[f"param{STEPS}/{k}"] = p.detach().numpy().copy()
    return out, metrics


# ---------------------------------------------------------------------------
# The ranks: `python tests/test_torch_dp.py <rank> <world> <port> <dir>`
# ---------------------------------------------------------------------------


def _worker(rank: int, world: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vstab_torch.core import config as tcfg
    from vstab_torch.core.config import DistConfig, FlowConfig
    from vstab_torch.dist import initialize, make_mesh, shutdown
    from vstab_torch.eval.deepstab import run_sweep
    from vstab_torch.flow import train as T
    from vstab_torch.flow.pwcnet import build_net, init_params
    from vstab_torch.pipeline import default_params

    initialize(DistConfig(coordinator_address=f"localhost:{port}", num_processes=world, process_id=rank),
               retries=3, backoff_s=1.0)
    world_group = dist.group.WORLD
    root = os.path.join(outdir, "..")
    arrays = dict(np.load(os.path.join(root, "inputs.npz")))
    params = {k[2:]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith("p/")}
    rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
    out, info = {}, {}
    for mode in MODES:
        got, metrics = _run_steps(params, mode, _batch_for(mode, arrays, rows), world_group)
        out.update({f"{mode}/{k}": v for k, v in got.items()})
        info[mode] = metrics

    # Uneven local batches: rank 0 holds one row more than the others.
    net = build_net({k: v.clone() for k, v in params.items()}, FlowConfig(**_FLOW)).train()
    step = T.make_train_step(net, T.make_optimizer(net.parameters(), LR), "supervised", group=world_group)
    uneven = slice(0, 3) if rank == 0 else slice(0, 2)
    try:
        step(_batch_for("supervised", arrays, uneven))
        info["uneven"] = "no error"
    except ValueError as e:
        info["uneven"] = str(e)

    if world == 4:  # the multi-device dry run, part (a): a 2x2 mesh, the batch over both axes
        mesh = make_mesh(DistConfig(data_axis=2, time_axis=2))
        cfg = FlowConfig(**_DRY_FLOW)
        net = build_net(init_params(0, cfg, "cpu"), cfg).train()
        step = T.make_train_step(net, T.make_optimizer(net.parameters(), 1e-4), "supervised", group=world_group)
        batch = T.synthetic_batch(torch.Generator().manual_seed(1), world, 64, 64)
        metrics = step({k: v[rank : rank + 1] for k, v in batch.items()})
        info["dry"] = {"mesh": [mesh.shape["data"], mesh.shape["time"], mesh.data_index, mesh.time_index],
                       **{k: float(v) for k, v in metrics.items()}}

    cfg = _sweep_cfg(tcfg)
    sweep_params = default_params(cfg, seed=0, ckpt_dir="/nonexistent", device="cpu")
    path = os.path.join(root, f"dp{world}.jsonl")
    kw = dict(cfg=cfg, params=sweep_params, n_synthetic=N_CLIPS, synth_shape=CLIP, device="cpu")
    info["sweep"] = run_sweep(None, path, data_parallel=True, **kw)
    info["again"] = run_sweep(None, path, data_parallel=True, **kw)

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    shutdown()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Writes the inputs, starts both world sizes, and computes the
    references here while the ranks run."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import vstab.core.config as jcfg
    import vstab.flow.train as jtrain
    from vstab.flow.pwcnet import init_params as init_params_ref
    from vstab_torch.core import config as tcfg
    from vstab_torch.eval.deepstab import run_sweep
    from vstab_torch.pipeline import default_params
    from vstab_torch.utils.checkpoint import params_from_jax

    torch.set_num_threads(1)
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    tmp = str(tmp_path_factory.mktemp("dp"))
    jparams = init_params_ref(jax.random.PRNGKey(0), jcfg.FlowConfig(**_FLOW))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    arrays = _global_batch()
    np.savez(os.path.join(tmp, "inputs.npz"), **arrays, **{f"p/{k}": v.numpy() for k, v in params.items()})
    worlds = {w: World(__file__, w, tmp, _WORKER_TIMEOUT_S) for w in WORLDS}

    ref = {"one": {}, "jax": {}, "dir": tmp}
    for mode in MODES:
        ref["one"][mode] = _run_steps(params, mode, _batch_for(mode, arrays))
    # The reference's sharded step: the batch over a ("data", "time") mesh of
    # as many CPU devices as ranks (2 = 1x2, 4 = 2x2, as the dry run lays it).
    tx = jtrain.make_optimizer(lr=LR)
    for world in WORLDS:
        d = 2 if world > 2 else 1
        mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(d, world // d), ("data", "time"))
        batch = jax.device_put({k: jnp.asarray(v) for k, v in arrays.items()}, NamedSharding(mesh, P(("data", "time"))))
        p = jax.device_put(jparams, NamedSharding(mesh, P()))
        state = jax.device_put(tx.init(jparams), NamedSharding(mesh, P()))
        step = jtrain.make_train_step(jcfg.FlowConfig(**_FLOW), tx, mode="supervised")
        got = []
        for _ in range(STEPS):
            p, state, m = step(p, state, batch)
            got.append({k: float(v) for k, v in m.items()})
        ref["jax"][world] = got

    cfg = _sweep_cfg(tcfg)
    ref["serial"] = run_sweep(
        None, os.path.join(tmp, "serial.jsonl"), cfg=cfg, n_synthetic=N_CLIPS, synth_shape=CLIP, device="cpu",
        params=default_params(cfg, seed=0, ckpt_dir="/nonexistent", device="cpu"),
    )
    return worlds, ref


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_gradients_match_one_process(env, world, mode):
    """The first step's averaged gradients against one process's on the
    whole batch, each leaf within 1e-5 of its largest |g|; the loss, its
    entries and grad_norm within 1e-5 relative."""
    worlds, ref = env
    want, want_metrics = ref["one"][mode]
    for arrays, info in worlds[world].ranks():
        got = info[mode][0]
        assert set(got) == set(want_metrics[0])
        for k, v in want_metrics[0].items():
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
        leaves = [k for k in want if k.startswith("grad1/")]
        assert len(leaves) == len([k for k in arrays if k.startswith(f"{mode}/grad1/")]) > 0
        for k in leaves:
            np.testing.assert_allclose(arrays[f"{mode}/{k}"], want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max(),
                                       err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_parameters_match_one_process(env, world, mode):
    """After one AdamW step: within 2*lr + 1e-6 of one process's."""
    worlds, ref = env
    want, _ = ref["one"][mode]
    arrays = worlds[world].ranks()[0][0]
    for k in (k for k in want if k.startswith("param1/")):
        np.testing.assert_allclose(arrays[f"{mode}/{k}"], want[k], rtol=0, atol=2 * LR + 1e-6, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_parameters_are_equal_on_every_rank(env, world, mode):
    """After 3 steps every rank holds the same parameters to the bit, and
    every rank read the same metrics."""
    worlds, _ = env
    ranks = worlds[world].ranks()
    first, info0 = ranks[0]
    keys = [k for k in first if k.startswith(f"{mode}/param{STEPS}/")]
    assert keys
    for arrays, info in ranks[1:]:
        assert info[mode] == info0[mode]
        for k in keys:
            np.testing.assert_array_equal(arrays[k], first[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_matches_the_jax_sharded_step(env, world):
    """Three supervised steps: loss, epe_finest and grad_norm within 1e-3
    relative of the JAX step on the batch sharded over `world` devices."""
    worlds, ref = env
    want = ref["jax"][world]
    for _, info in worlds[world].ranks():
        for got, w in zip(info["supervised"], want):
            assert set(got) == set(w)
            for k in w:
                assert abs(got[k] - w[k]) <= 1e-3 * abs(w[k]), (k, got[k], w[k])


@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_uneven_local_batches_raise_on_every_rank(env, world):
    worlds, _ = env
    for _, info in worlds[world].ranks():
        assert "local batches differ (2 to 3 rows)" in info["uneven"]


def test_dp_dryrun_four_ranks_on_a_2x2_mesh(env):
    """The multi-device dry run's part (a): 4 ranks laid out 2x2, one step
    over the world group with a row each, a finite loss on every rank."""
    worlds, _ = env
    ranks = worlds[4].ranks()
    for rank, (_, info) in enumerate(ranks):
        dry = info["dry"]
        assert dry["mesh"] == [2, 2, rank // 2, rank % 2]
        assert np.isfinite(dry["loss"]) and np.isfinite(dry["grad_norm"]) and dry["loss"] > 0
        assert dry == {**ranks[0][1]["dry"], "mesh": dry["mesh"]}


@pytest.mark.parametrize("world", WORLDS)
def test_dp_sweep_covers_all_clips_once(env, world):
    """Every rank returns a record a clip; the manifest holds one parseable
    line a clip, in clip order, written by rank 0 alone."""
    worlds, ref = env
    ranks = worlds[world].ranks()
    recs = ranks[0][1]["sweep"]
    assert [r["clip"] for r in recs] == _clip_names()
    for _, info in ranks[1:]:
        assert info["sweep"] == recs
    with open(os.path.join(ref["dir"], f"dp{world}.jsonl")) as f:
        lines = f.read().splitlines()
    assert [json.loads(line) for line in lines] == recs


@pytest.mark.parametrize("world", WORLDS)
def test_dp_sweep_metrics_match_serial(env, world):
    worlds, ref = env
    serial = {r["clip"]: r for r in ref["serial"]}
    assert sorted(serial) == sorted(_clip_names())
    for r in worlds[world].ranks()[0][1]["sweep"]:
        for k in ("stability", "cropping", "distortion"):
            assert abs(r[k] - serial[r["clip"]][k]) < 5e-3, (r["clip"], k, r[k], serial[r["clip"]][k])
        assert r["frames"] == CLIP[0]


@pytest.mark.parametrize("world", WORLDS)
def test_dp_sweep_tail_group_records_its_size(env, world):
    """9 clips in groups of `world`: full groups, then a tail of one clip;
    within a group every record carries the slowest rank's wall time."""
    worlds, _ = env
    recs = worlds[world].ranks()[0][1]["sweep"]
    assert [r["batch"] for r in recs] == [world] * (N_CLIPS - 1) + [1]
    for i in range(0, N_CLIPS - 1, world):
        group = recs[i : i + world]
        assert len({r["batch_wall_s"] for r in group}) == 1
        assert all(abs(r["wall_s"] - r["batch_wall_s"] / world) <= 1e-3 for r in group)  # both rounded to 1e-3


@pytest.mark.parametrize("world", WORLDS)
def test_dp_sweep_resume_skips_done(env, world):
    worlds, ref = env
    for _, info in worlds[world].ranks():
        assert info["again"] == info["sweep"]
    with open(os.path.join(ref["dir"], f"dp{world}.jsonl")) as f:
        assert len([line for line in f if line.strip()]) == N_CLIPS, "resume re-ran finished clips"


def test_dp_sweep_without_a_process_group_runs_one_clip_at_a_time(tmp_path):
    from vstab_torch.core import config as tcfg
    from vstab_torch.eval.deepstab import run_sweep
    from vstab_torch.pipeline import default_params

    cfg = _sweep_cfg(tcfg)
    params = default_params(cfg, seed=0, ckpt_dir="/nonexistent", device="cpu")
    recs = run_sweep(None, str(tmp_path / "r.jsonl"), cfg=cfg, params=params, n_synthetic=2, synth_shape=CLIP,
                     data_parallel=True, device="cpu")
    assert [r["clip"] for r in recs] == _clip_names()[:2] and all(r["batch"] == 1 for r in recs)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
