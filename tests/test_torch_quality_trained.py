"""The gates of tests/integration/test_trained.py:46-78, held on the port on
the CPU: `flow_086000` with f32 flow on the 48x160x192 checker clip (affine
and sparse-LS smoothing) and on the perlin clip the network never trained
on, each under the K input-noise draws of
`tests/torch_quality_reference.json` and held on their mean as
`vstab_torch.eval.quality.hold_gates` sets out (the noiseless reading
printed beside it). The two runs of a clip share its flow.
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
RUNS = ["trained_affine", "trained_sparse_ls", "perlin_sparse_ls"]
GATES = [g["name"] for g in REF["gates"]["list"] if g["run"] in RUNS]


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
