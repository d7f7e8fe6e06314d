"""vstab_torch.dist on the CPU: 2 and 4 gloo ranks against the JAX package.

Each world size is brought up once for the module, through
`vstab_torch.dist.initialize`, as processes running this file's `__main__`
block (they import torch, never JAX). The ranks run every case and write
their results under a temporary directory; the tests then hold them against
the JAX package (its CPU mesh of 8 devices, `kernel_impl="xla"`, f32) and
against the port's one-device functions, computed here while the ranks run.

Tolerances:
- mesh layout and halo exchange: equal to the JAX `make_mesh` and to the
  JAX halo functions under `shard_map` on a mesh of as many time devices;
- `schur_solve_shard` at the reference's three shapes: within 2e-5 of the
  JAX `schur_solve` (the reference's own tolerance), within 1e-6 of the
  port's `schur_solve`, within 1e-4 of the banded oracle;
- `stabilize_sharded` (tiny flow network, 64x48x64 clips): every value
  within 2e-5 of the port's `stabilize` (`SERIAL_TOL`), and within 2e-3 of
  the JAX `stabilize_sharded` on a mesh of the same time size (same padded
  length) wherever the port's `stabilize` is within 2e-3 - 2e-5 of it (it
  is not at 29 of 589,824 values with 'fixed' crop on this clip: a validity
  test on a frame edge or a bilinear tap that flips between the two f32
  implementations);
- strong shake (flow_086000, 32x96x128): the same bucket, above 16, as the
  port's `stabilize`, and under 1e-5 of the values more than 5e-3 apart.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch_ranks import REPO, World

CKPTS = os.path.join(REPO, "ckpts")
WORLDS = (2, 4)
PIPE_CASES = ("sparse", "affine", "auto")
SCHUR_SHAPES = ((128, 6, 8), (256, 4, 16), (64, 2, 8))
HALO_FNS = ("shift_from_next", "shift_from_prev", "extend_right", "exclusive_prefix_sum")
# (data_axis, time_axis) of the DistConfigs whose layout the ranks report.
MESH_AXES = ((1, 1), (0, 0), (1, 0), (0, 2), (2, 0), (2, 2), (4, 1), (3, 2))
DRY_SHAPES = ((32, 48, 64), (32, 32, 3840))
# The sharded pipeline against the port's one-device `stabilize` on the same
# clip: the flow of a rank's slice batches its pairs otherwise (up to 5e-6
# apart on 4 ranks); the Schur solve is bit for bit the one-device one.
SERIAL_TOL = 2e-5
_WORKER_TIMEOUT_S = 400


def _cfg(mod, case="sparse"):
    """The tiny configuration of the reference's sharded pipeline tests."""
    cfg = mod.Config(
        flow=mod.FlowConfig(
            pyramid_channels=(8, 16, 24), estimator_channels=(16, 16), context_dilations=(1, 2, 1),
            search_radius=2, kernel_impl="xla", compute_dtype="float32", output_level=2,
        ),
        smooth=mod.SmoothConfig(method="sparse_ls", grid_size=(4, 4), block_len=8),
    )
    if case == "affine":
        return cfg.replace(smooth=mod.SmoothConfig(method="affine", affine_sigma=5.0, block_len=8))
    if case == "auto":
        return cfg.replace(render=mod.RenderConfig(crop_mode="auto", kernel_impl="xla"))
    if case == "shake":
        return mod.Config(
            flow=mod.FlowConfig(compute_dtype="float32", kernel_impl="xla"),
            render=mod.RenderConfig(kernel_impl="xla"),
            smooth=mod.SmoothConfig(block_len=4),
        )
    return cfg


def _inputs():
    """Clips of the cases, made from seeds with numpy."""
    from vstab_torch.eval.synthetic import make_shaky_clip

    rng = np.random.default_rng(0)
    clips = {
        "sparse": make_shaky_clip(t=64, h=48, w=64, seed=0)[0],
        "affine": make_shaky_clip(t=64, h=48, w=64, seed=2)[0],
        "odd": make_shaky_clip(t=50, h=48, w=64, seed=1)[0],
        "shake": make_shaky_clip(t=32, h=96, w=128, seed=5, shake_px=6.0, shake_angle=0.15)[0],
    }
    clips["auto"] = clips["sparse"]
    for t, h, w in DRY_SHAPES:
        clips[f"dry{w}"] = rng.random((t, h, w, 3), np.float32)
    return clips


def _halo_input(n_rows):
    return np.arange(n_rows, dtype=np.float32).reshape(n_rows, 1)


def _prefix_input(n_rows):
    return np.random.default_rng(0).normal(size=(n_rows, 3)).astype(np.float32)


def _random_spd_penta(t, m, seed=0):
    """Random SPD pentadiagonal bands in the length-T convention (the
    reference's test inputs)."""
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(t, m)).astype(np.float32)
    d2 = rng.normal(size=(t, m)).astype(np.float32)
    d1[-1] = 0.0
    d2[-2:] = 0.0
    d0 = (
        4.0 + np.abs(d1) + np.abs(np.roll(d1, 1, 0)) + np.abs(d2) + np.abs(np.roll(d2, 2, 0))
    ).astype(np.float32)
    b = rng.normal(size=(t, m)).astype(np.float32)
    return d0, d1, d2, b


# ---------------------------------------------------------------------------
# The ranks: `python tests/test_torch_dist.py <rank> <world> <port> <dir>`
# ---------------------------------------------------------------------------


def _halo_case(group, x, rows, out, key):
    from vstab_torch.dist import extend_right, shift_from_next, shift_from_prev

    xl = torch.from_numpy(x[rows])
    out[f"{key}/shift_from_next"] = shift_from_next(xl, 2, group)
    out[f"{key}/shift_from_prev"] = shift_from_prev(xl, 1, group)
    out[f"{key}/extend_right"] = extend_right(xl, 1, group)


def _prefix_case(group, x, rows, out, key):
    from vstab_torch.dist import exclusive_prefix_sum

    local = torch.from_numpy(x[rows])
    out[f"{key}/exclusive_prefix_sum"] = exclusive_prefix_sum(local[0], group)[None]
    cum = torch.cumsum(local, dim=0)
    out[f"{key}/cumsum"] = cum + exclusive_prefix_sum(cum[-1], group)[None]


def _worker(rank: int, world: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    from vstab_torch.core import config as tcfg
    from vstab_torch.dist import initialize, make_mesh, schur_solve_shard, shutdown, stabilize_sharded
    from vstab_torch.pipeline import default_params

    initialize(tcfg.DistConfig(coordinator_address=f"localhost:{port}", num_processes=world, process_id=rank),
               retries=3, backoff_s=1.0)
    out, info = {}, {"layouts": {}}
    for d, t in MESH_AXES:
        try:
            m = make_mesh(tcfg.DistConfig(data_axis=d, time_axis=t))
            info["layouts"][f"{d}x{t}"] = [m.shape["data"], m.shape["time"], m.data_index, m.time_index]
        except ValueError as e:
            info["layouts"][f"{d}x{t}"] = str(e)

    mesh = make_mesh(tcfg.DistConfig(time_axis=world))
    g = mesh.time_group
    rows = slice(4 * rank, 4 * rank + 4)
    _halo_case(g, _halo_input(4 * world), rows, out, "1xW")
    _prefix_case(g, _prefix_input(4 * world), rows, out, "1xW")
    if world == 4:  # the time groups of a 2x2 grid: rows 0 and 1 hold different data
        m22 = make_mesh(tcfg.DistConfig(data_axis=2, time_axis=2))
        r22 = slice(4 * m22.time_index, 4 * m22.time_index + 4)
        _halo_case(m22.time_group, _halo_input(8) + 100 * m22.data_index, r22, out, "2x2")
        _prefix_case(m22.time_group, _prefix_input(8) + 100 * m22.data_index, r22, out, "2x2")

    for t, m, bl in SCHUR_SHAPES:
        t_loc = t // world
        sl = slice(rank * t_loc, (rank + 1) * t_loc)
        bands = [torch.from_numpy(a[sl]) for a in _random_spd_penta(t, m)]
        out[f"schur/{t}-{m}-{bl}"] = schur_solve_shard(*bands, bl, g)

    clips = np.load(os.path.join(outdir, "..", "inputs.npz"))
    tiny = {k[2:]: torch.from_numpy(v) for k, v in np.load(os.path.join(outdir, "..", "params.npz")).items()}
    for case in PIPE_CASES:
        o, dg = stabilize_sharded(clips[case], tiny, _cfg(tcfg, case), mesh=mesh, device="cpu", gather=True)
        out[f"pipe/{case}"] = o
        info[f"pipe/{case}"] = dg
    o, dg = stabilize_sharded(clips["odd"], tiny, _cfg(tcfg), mesh=mesh, device="cpu")
    out["pipe/odd"] = o
    info["pipe/odd"] = dg
    bad = _cfg(tcfg).replace(smooth=dataclasses.replace(_cfg(tcfg).smooth, method="nope"))
    try:
        stabilize_sharded(clips["sparse"], tiny, bad, mesh=mesh, device="cpu")
        info["unknown_method"] = "no error"
    except ValueError as e:
        info["unknown_method"] = str(e)
    try:  # with the process group up, a mesh made on every call would leak groups
        stabilize_sharded(clips["sparse"], tiny, _cfg(tcfg), device="cpu")
        info["no_mesh"] = "no error"
    except ValueError as e:
        info["no_mesh"] = str(e)
    shake = _cfg(tcfg, "shake")
    o, dg = stabilize_sharded(clips["shake"], default_params(shake, ckpt_dir=CKPTS, device="cpu"), shake,
                              mesh=mesh, device="cpu", gather=True)
    out["pipe/shake"] = o
    info["pipe/shake"] = dg
    if world == 4:  # the multi-device dry run's time-sharded inference, at 64 and 3840 columns
        for _, _, w in DRY_SHAPES:
            o, dg = stabilize_sharded(clips[f"dry{w}"], tiny, _cfg(tcfg), mesh=mesh, device="cpu")
            out[f"dry/{w}"] = o
            info[f"dry/{w}"] = dg

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **{k: v.numpy() for k, v in out.items()})
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    shutdown()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("data", "time"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Writes the inputs, starts both world sizes, and computes the
    references here while the ranks run."""
    import jax
    import jax.numpy as jnp

    import vstab.core.config as jcfg
    from vstab.dist.pipeline_dist import stabilize_sharded as sharded_ref
    from vstab.flow.pwcnet import init_params
    from vstab.smooth.schur import schur_solve as schur_ref
    from vstab.smooth.banded import banded_solve_scan as banded_ref
    import vstab_torch
    from vstab_torch.core import config as tcfg
    from vstab_torch.pipeline import default_params
    from vstab_torch.smooth.schur import schur_solve
    from vstab_torch.utils.checkpoint import params_from_jax

    torch.set_num_threads(1)
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    tmp = str(tmp_path_factory.mktemp("dist"))
    clips = _inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), **clips)
    jparams = init_params(jax.random.PRNGKey(0), _cfg(jcfg).flow)
    tiny = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    np.savez(os.path.join(tmp, "params.npz"), **{f"p/{k}": v.numpy() for k, v in tiny.items()})
    worlds = {w: World(__file__, w, tmp, _WORKER_TIMEOUT_S) for w in WORLDS}

    ref = {"schur": {}, "pipe_jax": {}, "pipe_port": {}}
    for t, m, bl in SCHUR_SHAPES:
        d0, d1, d2, b = _random_spd_penta(t, m)
        ref["schur"][(t, m, bl)] = {
            "jax": np.asarray(schur_ref(jnp.asarray(d0), jnp.asarray(d1[:-1]), jnp.asarray(d2[:-2]),
                                        jnp.asarray(b), block_len=bl)),
            "port": schur_solve(*(torch.from_numpy(a) for a in (d0, d1[:-1], d2[:-2], b)), block_len=bl).numpy(),
            "banded": np.asarray(banded_ref(jnp.asarray(d0), jnp.asarray(d1[:-1]), jnp.asarray(d2[:-2]),
                                            jnp.asarray(b))),
        }
    for case in PIPE_CASES:
        ref["pipe_port"][case] = vstab_torch.stabilize(clips[case], tiny, _cfg(tcfg, case), device="cpu")[0].numpy()
        for w in WORLDS:
            ref["pipe_jax"][(case, w)] = np.asarray(
                sharded_ref(jnp.asarray(clips[case]), jparams, _cfg(jcfg, case), mesh=_jax_mesh(w)))
    shake = _cfg(tcfg, "shake")
    got, diags = vstab_torch.stabilize(clips["shake"], default_params(shake, ckpt_dir=CKPTS, device="cpu"),
                                       shake, device="cpu")
    ref["shake"] = (got.numpy(), diags)
    ref["tiny"], ref["clips"] = tiny, clips
    return worlds, ref


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_layout_matches_reference(env, world):
    """make_mesh's axis sizes over `world` ranks are the JAX make_mesh's over
    as many devices, and each rank sits at (rank // t, rank % t)."""
    import jax

    from vstab.core.config import DistConfig
    from vstab.dist.mesh import make_mesh as make_mesh_ref

    worlds, _ = env
    for rank, (_, info) in enumerate(worlds[world].ranks()):
        for d, t in MESH_AXES:
            got = info["layouts"][f"{d}x{t}"]
            try:
                want = make_mesh_ref(DistConfig(data_axis=d, time_axis=t), devices=jax.devices()[:world]).shape
            except ValueError as e:
                assert got == str(e), (d, t)
                continue
            tw = want["time"]
            on = rank < want["data"] * tw
            assert got == [want["data"], tw, rank // tw if on else None, rank % tw if on else None], (d, t)


def _halo_ref(fn, x, n):
    import jax
    from jax.sharding import PartitionSpec as P

    import vstab.dist.halo as H

    def body(s):
        if fn == "exclusive_prefix_sum":  # of each shard's first row: [1, ...] a shard
            return H.exclusive_prefix_sum(s[0], "time")[None]
        return getattr(H, fn)(s, 2 if fn == "shift_from_next" else 1, "time")

    f = jax.shard_map(body, mesh=_jax_mesh(n), in_specs=P("time"), out_specs=P("time"), check_vma=False)
    return np.asarray(jax.jit(f)(jax.numpy.asarray(x)))


def _halo_x(fn, n_rows):
    return (_prefix_input if fn == "exclusive_prefix_sum" else _halo_input)(n_rows)


@pytest.mark.parametrize("fn", HALO_FNS)
@pytest.mark.parametrize("world", WORLDS)
def test_halo_equals_reference(env, world, fn):
    worlds, _ = env
    x = _halo_x(fn, 4 * world)
    np.testing.assert_array_equal(worlds[world].cat(f"1xW/{fn}"), _halo_ref(fn, x, world))
    if fn == "exclusive_prefix_sum":  # a distributed cumsum, as the reference's test holds it
        np.testing.assert_allclose(worlds[world].cat("1xW/cumsum"), np.cumsum(x, axis=0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", HALO_FNS)
def test_halo_on_the_time_groups_of_a_2x2_mesh(env, fn):
    """4 ranks as 2 data rows of 2 time ranks: each row exchanges only within
    itself, as a 2-device JAX mesh on that row's data."""
    worlds, _ = env
    ranks = worlds[4].ranks()
    for row in range(2):
        got = np.concatenate([ranks[2 * row + j][0][f"2x2/{fn}"] for j in range(2)])
        np.testing.assert_array_equal(got, _halo_ref(fn, _halo_x(fn, 8) + 100 * row, 2))


@pytest.mark.parametrize("against", ["jax", "port", "banded"])
@pytest.mark.parametrize("t,m,bl", SCHUR_SHAPES)
@pytest.mark.parametrize("world", WORLDS)
def test_schur_solve_shard(env, world, t, m, bl, against):
    worlds, ref = env
    got = worlds[world].cat(f"schur/{t}-{m}-{bl}")
    want = ref["schur"][(t, m, bl)][against]
    if against == "port":
        print(f"schur_solve_shard on {world} ranks, {(t, m, bl)}: bit for bit equal to schur_solve: "
              f"{np.array_equal(got, want)}, max_abs_err {np.abs(got - want).max():.3e}")
    tol = {"jax": 2e-5, "port": 1e-6, "banded": 1e-4}[against]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("against", ["jax_sharded", "port_stabilize"])
@pytest.mark.parametrize("case", PIPE_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_stabilize_sharded(env, world, case, against):
    """Gathered output on every rank, against the JAX `stabilize_sharded` on
    a mesh of `world` time devices and against the port's `stabilize`."""
    worlds, ref = env
    ranks = worlds[world].ranks()
    got = ranks[0][0][f"pipe/{case}"]
    assert got.shape == (64, 48, 64, 3) and np.isfinite(got).all()
    for arrays, info in ranks[1:]:
        np.testing.assert_array_equal(arrays[f"pipe/{case}"], got)
    assert ranks[0][1][f"pipe/{case}"]["t_pad"] == 64 and ranks[0][1][f"pipe/{case}"]["start"] == 0
    serial = ref["pipe_port"][case]
    if against == "port_stabilize":
        np.testing.assert_allclose(got, serial, rtol=0, atol=SERIAL_TOL)
        return
    # Every value within 2e-3, excusing only the values where the port's
    # one-device `stabilize` is itself beyond 2e-3 - SERIAL_TOL of the JAX
    # package (a validity test on a frame edge, a bilinear tap that flips
    # between the two f32 implementations): elsewhere the case above bounds
    # the sharded output within 2e-3.
    want = ref["pipe_jax"][(case, world)]
    out = np.abs(got - want) > 2e-3
    excused = np.abs(serial - want) > 2e-3 - SERIAL_TOL
    print(f"{case} on {world} ranks against the JAX stabilize_sharded: {int(out.sum())} values out of 2e-3, "
          f"the port's stabilize {int((np.abs(serial - want) > 2e-3).sum())}, of {out.size}; "
          f"{int(excused.sum())} excused; max |sharded - stabilize| {np.abs(got - serial).max():.3e}")
    assert not (out & ~excused).any(), f"{int((out & ~excused).sum())} values out of 2e-3 and not excused"


@pytest.mark.parametrize("world", WORLDS)
def test_stabilize_sharded_auto_crop_takes_the_min_over_real_frames(env, world):
    """'auto' crop: one scale on every rank, the port's own clip-wide one."""
    from vstab_torch.core import config as tcfg
    from vstab_torch.pipeline import path_to_flow, smooth_paths, clip_flow
    from vstab_torch.render.render import _auto_scale_per_frame

    worlds, ref = env
    scales = {info["pipe/auto"]["crop_scale"] for _, info in worlds[world].ranks()}
    assert len(scales) == 1
    cfg = _cfg(tcfg, "auto")
    frames = torch.from_numpy(ref["clips"]["auto"])
    path, _ = smooth_paths(clip_flow(ref["tiny"], frames, cfg), cfg, (48, 64))
    want = float(_auto_scale_per_frame(path_to_flow(path, cfg, (48, 64))).min())
    assert abs(scales.pop() - want) <= 1e-5 and want < 1.0


@pytest.mark.parametrize("world", WORLDS)
def test_stabilize_sharded_pads_odd_length(env, world):
    """T=50: every rank returns its own rows of the 50 with their start."""
    worlds, _ = env
    ranks = worlds[world].ranks()
    t_loc = 64 // world
    starts = [info["pipe/odd"]["start"] for _, info in ranks]
    assert starts == [r * t_loc for r in range(world)]
    assert [a["pipe/odd"].shape[0] for a, _ in ranks] == [max(0, min(t_loc, 50 - s)) for s in starts]
    out = worlds[world].cat("pipe/odd")
    assert out.shape == (50, 48, 64, 3) and np.isfinite(out).all()


@pytest.mark.parametrize("world", WORLDS)
def test_stabilize_sharded_unknown_method_raises(env, world):
    worlds, _ = env
    for _, info in worlds[world].ranks():
        assert "unknown smoothing method" in info["unknown_method"]


@pytest.mark.parametrize("world", WORLDS)
def test_stabilize_sharded_needs_a_mesh_with_a_process_group(env, world):
    worlds, _ = env
    for _, info in worlds[world].ranks():
        assert "pass mesh=make_mesh(cfg.dist)" in info["no_mesh"]


@pytest.mark.parametrize("world", WORLDS)
def test_stabilize_sharded_strong_shake_same_bucket(env, world):
    """flow_086000 with rotation shake: the solved bound exceeds 16 px, and
    the sharded render uses the serial path's bucket."""
    from vstab_torch.core import config as tcfg
    from vstab_torch.pipeline import render_bucket

    worlds, ref = env
    ranks = worlds[world].ranks()
    serial, diags = ref["shake"]
    cfg = _cfg(tcfg, "shake")
    bound, d = render_bucket(diags["profiles"] - diags["smoothed"], cfg, (96, 128))
    assert bound > 16.0 and d > 16, f"scenario too mild (bound={bound:.1f}px)"
    assert all(info["pipe/shake"]["max_disp"] == d for _, info in ranks)
    got = ranks[0][0]["pipe/shake"]
    frac_bad = float((np.abs(got - serial) > 5e-3).mean())
    assert got.shape == serial.shape and frac_bad < 1e-5, f"{frac_bad:.2e} of values differ (> 5e-3)"


def test_initialize_two_processes_matches_one_process(env):
    """The 2-rank world that `initialize` brought up gives rank 0 the output
    of the one-process run (a world of one, no process group)."""
    from vstab_torch.dist import make_mesh, stabilize_sharded
    from vstab_torch.core import config as tcfg
    import torch.distributed as dist

    worlds, ref = env
    assert not dist.is_initialized()
    one, diags = stabilize_sharded(ref["clips"]["sparse"], ref["tiny"], _cfg(tcfg), device="cpu")
    assert diags["n_time"] == 1 and make_mesh().time_group is None
    np.testing.assert_allclose(worlds[2].ranks()[0][0]["pipe/sparse"], one.numpy(), rtol=0, atol=2e-3)


def test_initialize_is_a_noop_for_one_process():
    import torch.distributed as dist

    from vstab_torch.core.config import DistConfig
    from vstab_torch.dist import initialize, make_mesh, shutdown

    initialize(DistConfig())
    initialize(DistConfig(coordinator_address="localhost:1", num_processes=1))
    assert not dist.is_initialized()
    assert make_mesh().shape == {"data": 1, "time": 1}
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh(DistConfig(time_axis=2))
    shutdown()


@pytest.mark.parametrize("t,h,w", DRY_SHAPES)
def test_dryrun_four_ranks(env, t, h, w):
    """The multi-device dry run's time-sharded inference on 4 ranks: random
    clips at 64 and at 3840 columns, finite and of the clip's shape."""
    worlds, _ = env
    out = worlds[4].cat(f"dry/{w}")
    assert out.shape == (t, h, w, 3) and np.isfinite(out).all()


def test_entry_points_raise_without_a_card():
    from vstab_torch.core.config import Config
    from vstab_torch.dist import stabilize_sharded

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stabilize_sharded(np.zeros((4, 8, 8, 3), np.float32), {}, Config())


@pytest.mark.parametrize("method", ["sparse_ls", "affine"])
def test_residual_disp_bound_t_matches_host_and_reference(method):
    """The bound on a tensor (what each rank computes on its slice) against
    the JAX package's host and in-graph versions, on random paths of either
    kind."""
    import jax.numpy as jnp

    from vstab.render.render import residual_disp_bound as host_ref
    from vstab.render.render import residual_disp_bound_jnp
    from vstab_torch.render.render import residual_disp_bound

    rng = np.random.default_rng(3)
    if method == "affine":
        path = (np.eye(2, 3) + rng.normal(size=(9, 2, 3)) * [[0.01, 0.01, 20.0]]).astype(np.float32)
    else:
        path = (rng.normal(size=(9, 12, 16, 2)) * 8.0).astype(np.float32)
    got = residual_disp_bound(torch.from_numpy(path), 720, 1280, method)
    assert got.dtype == torch.float32 and got.dim() == 0
    for want in (host_ref(path, 720, 1280, method),
                 float(residual_disp_bound_jnp(jnp.asarray(path), 720, 1280, method))):
        assert abs(float(got) - want) <= 1e-5 * want
    assert float(residual_disp_bound(torch.zeros((0, 2, 3)), 720, 1280, "affine")) == 0.0


@pytest.mark.parametrize("k,m", [(4, 6), (1, 3)])
def test_reduce_separator_system_matches_reference(k, m):
    import jax.numpy as jnp

    from vstab.smooth.schur import reduce_separator_system as reduce_ref
    from vstab_torch.smooth.schur import reduce_separator_system

    rng = np.random.default_rng(k)
    d_sep = rng.normal(size=(k, m, 2, 2)).astype(np.float32)
    contrib = [rng.normal(size=s).astype(np.float32) for s in [(k, m, 2, 2)] * 3 + [(k, m, 2)] * 2]
    got = reduce_separator_system(torch.from_numpy(d_sep), [torch.from_numpy(c) for c in contrib])
    want = reduce_ref(jnp.asarray(d_sep), [jnp.asarray(c) for c in contrib])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
