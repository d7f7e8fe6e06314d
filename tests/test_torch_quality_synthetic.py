"""The gates of tests/integration/test_synthetic.py, held on the port on the
CPU: the clip's known camera path as the flow, through `smooth_and_render`
(the smoothing and the render alone, no network).

A score gate is held on the mean over the K input-noise draws of
`tests/torch_quality_reference.json`: where the JAX package's own mean clears
the gate, the port's must clear it too, else the port's must lie within the
f32 tolerance for n = K of the JAX package's mean
(`vstab_torch.eval.quality.hold_gates`). The noiseless reading is printed
beside each mean. The still clip and the output's range are held as the JAX
test holds them.
"""

import json
import os

import numpy as np
import pytest
import torch

import vstab_torch
from vstab_torch.eval import quality
from vstab_torch.eval.synthetic import checker_scene
from vstab_torch.pipeline import clip_flow, default_params, smooth_and_render, stabilize_from_flow

torch.set_num_threads(4)

REF = quality.load_reference(os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_quality_reference.json"))
RUNS = ["synthetic_affine", "synthetic_sparse_ls"]
GATES = [g["name"] for g in REF["gates"]["list"] if g["run"] in RUNS]


@pytest.fixture(scope="module")
def rows():
    readings = quality.gate_readings(REF, {}, "float32", "cpu", runs=RUNS)
    return {r["gate"]: r for r in quality.hold_gates(REF, readings, "float32")}


@pytest.mark.parametrize("gate", GATES)
def test_gate_on_the_mean_over_the_draws(rows, gate, capsys):
    row = rows[gate]
    with capsys.disabled():
        print(f"\n{json.dumps(row)}")
    assert row["ok"], row


def test_still_clip_is_near_identity():
    scene = checker_scene(96, 128, seed=1)
    frames = torch.from_numpy(np.broadcast_to(scene, (12, 96, 128, 3)).copy())
    cfg = quality.config({"smooth": {"method": "sparse_ls"}, "render": {"crop_mode": "none"}})
    out, _ = smooth_and_render(frames, torch.zeros(11, 96, 128, 2), cfg)
    change = float((out - frames).abs().max())
    assert change <= REF["gates"]["still_clip_tolerance"], (change, REF["gates"]["still_clip_max_abs_change"])


def test_output_shape_and_range():
    frames, cams = quality.gate_clip(REF, "shaky_seed3")
    fr = torch.from_numpy(frames)
    out, _ = smooth_and_render(fr, quality.analytic_flow(cams, *frames.shape[1:3], "cpu"),
                               quality.config({"smooth": {"method": "sparse_ls"}}))
    slack = REF["gates"]["output_range_slack"]
    assert out.shape == fr.shape and bool(torch.isfinite(out).all())
    assert float(out.min()) >= -slack and float(out.max()) <= 1.0 + slack, REF["gates"]["output_range"]


def test_stabilize_from_flow_is_stabilize():
    """The gates share a clip's flow between the runs that differ only in
    smoothing or render: `stabilize_from_flow` must be `stabilize` given
    that flow, to the bit (a tiny random network, both smoothing methods,
    the adaptive render bucket and the static bound)."""
    frames, _ = quality.gate_clip(REF, "shaky_seed3")
    frames = frames[:9, :64, :96].copy()
    tiny = {"flow": {"pyramid_channels": [8, 12, 16], "estimator_channels": [16, 12], "output_level": 1,
                     "compute_dtype": "float32"}}
    for method in ("affine", "sparse_ls"):
        for adaptive in (True, False):
            cfg = quality.config({**tiny, "smooth": {"method": method, "grid_size": [4, 4]},
                                  "render": {"crop_mode": "fixed", "fixed_crop_ratio": 0.8,
                                             "adaptive_max_disp": adaptive}})
            params = default_params(cfg, seed=0, ckpt_dir="/nonexistent", device="cpu")
            want, _ = vstab_torch.stabilize(frames, params, cfg, device="cpu")
            fr = torch.from_numpy(frames)
            got, _ = stabilize_from_flow(fr, clip_flow(params, fr, cfg), cfg)
            assert torch.equal(got, want), (method, adaptive)
