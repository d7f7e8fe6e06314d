"""The frozen traffic generators: shapes, ranges, seeds, and the shake's
statistics against the repo's numpy generator."""

import json
import os

import numpy as np
import pytest
import torch

from h100bench import harness
from h100bench.generators import scene_pool, shaky_clips
from h100bench.reference import stabilize as ref

CPU = torch.device("cpu")
BIG_SEED = 2**31 + 987654321


def _mix(**kw):
    m = dict(harness.load_json("traffic", "clips_720p"))
    m.update(clips=2, frames=5, height=36, width=48, **kw)
    return m


@pytest.mark.parametrize("dtype,place", [("float32", "device"), ("uint8", "host")])
def test_clip_shapes_ranges_and_seeds(dtype, place):
    a = shaky_clips.generate(_mix(dtype=dtype, place=place), BIG_SEED, CPU)["clips"]
    b = shaky_clips.generate(_mix(dtype=dtype, place=place), BIG_SEED, CPU)["clips"]
    c = shaky_clips.generate(_mix(dtype=dtype, place=place), BIG_SEED + 1, CPU)["clips"]
    assert len(a) == 2
    for x in a:
        assert tuple(x.shape) == (5, 36, 48, 3)
        if place == "host":
            assert isinstance(x, np.ndarray) and x.dtype == np.uint8
        else:
            assert x.dtype == torch.float32 and float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))
    assert not np.array_equal(np.asarray(a[0]), np.asarray(c[0]))
    assert not np.array_equal(np.asarray(a[0]), np.asarray(a[1]))


def test_scene_pool():
    mix = dict(harness.load_json("traffic", "scenes_192x256"), scenes=5, height=32, width=40)
    a = scene_pool.generate(mix, BIG_SEED, CPU)
    b = scene_pool.generate(mix, BIG_SEED, CPU)
    c = scene_pool.generate(mix, 3, CPU)
    assert tuple(a["scenes"].shape) == (5, 32, 40, 3)
    assert float(a["scenes"].min()) >= 0.0 and float(a["scenes"].max()) <= 1.0
    assert torch.equal(a["scenes"], b["scenes"]) and not torch.equal(a["scenes"], c["scenes"])
    assert a["batch_seed"] == BIG_SEED + mix["batch_seed_offset"]


def _ideal_bound(cams: np.ndarray, t: int, h: int, w: int, cfg) -> float:
    """The residual bound of the stabilizer's path for the exact motion of a
    camera path (no flow network)."""
    a = np.zeros((t, 3, 3))
    a[:, :2] = cams
    a[:, 2, 2] = 1.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.stack([xs, ys, np.ones_like(xs)], -1)
    flows = []
    for i in range(t - 1):
        q = p @ (np.linalg.inv(a[i + 1]) @ a[i]).T
        flows.append(q[..., :2] - p[..., :2])
    flow = torch.from_numpy(np.stack(flows)).float()
    s = cfg["smooth"]
    m = ref.vertex_motion(flow, tuple(s["grid_size"]), 0)
    c = torch.cat([torch.zeros_like(m[:1]), torch.cumsum(m, 0)])
    return ref.residual_bound(c - ref.smooth_profiles(c, s), h, w)


def test_the_shake_bounds_the_path_as_the_numpy_generator_does():
    from vstab_torch.eval.synthetic import jitter_trajectory

    with open(os.path.join(harness.ROOT, "h100bench/configs/pwcnet_stabilize.json")) as f:
        cfg = json.load(f)["program"]
    t, h, w = 48, 180, 320
    ours = [_ideal_bound(shaky_clips.trajectory(torch.Generator().manual_seed(s), t, 3.0, 6.0,
                                                0.01).numpy(), t, h, w, cfg) for s in range(8)]
    theirs = [_ideal_bound(jitter_trajectory(t, seed=s), t, h, w, cfg) for s in range(8)]
    assert np.mean(ours) == pytest.approx(np.mean(theirs), rel=0.3)
    assert np.std(ours) == pytest.approx(np.std(theirs), rel=1.0)
