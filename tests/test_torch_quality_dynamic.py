"""The gates of tests/integration/test_dynamic.py, held on the port on the
CPU: `flow_086000` with f32 flow on the 48x160x192 clip with moving
occluders, robust (robust_iters=2) against mean (0) pooling, and the solved
path's mean deviation from the occluder-free clip's; each under the K
input-noise draws of `tests/torch_quality_reference.json` and held on their
mean as `vstab_torch.eval.quality.hold_gates` sets out (the noiseless reading
printed beside it). For the JAX package itself one reading of the gate of
0.75 is near a coin flip: its draws read 0.669 to 0.893.
"""

import json
import os

import pytest
import torch

from vstab_torch.eval import quality
from vstab_torch.pipeline import default_params

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = quality.load_reference(os.path.join(REPO, "tests", "torch_quality_reference.json"))
RUNS = ["dynamic_robust2", "dynamic_robust0"]
GATES = [g["name"] for g in REF["gates"]["list"] if g["run"] in RUNS or g["run"] == "path_deviation"]


@pytest.fixture(scope="module")
def rows():
    params = default_params(quality.config({}, "float32"), ckpt_dir=os.path.join(REPO, "ckpts"), device="cpu")
    readings = quality.gate_readings(REF, params, "float32", "cpu", runs=RUNS)
    return {r["gate"]: r for r in quality.hold_gates(REF, readings, "float32")}


@pytest.mark.parametrize("gate", GATES)
def test_gate_on_the_mean_over_the_draws(rows, gate, capsys):
    row = rows[gate]
    with capsys.disabled():
        print(f"\n{json.dumps(row)}")
    assert row["ok"], row
