"""The gates of tests/integration/test_dynamic.py on its clip as that test
draws it where OpenCV is installed: the JAX package's generator with OpenCV,
not the numpy paths that every other quality clip is drawn by. Both packages
draw and track with the one installed OpenCV, so the port is held on the
clip the JAX integration test itself scores, to the JAX package's readings on it
(`opencv_dynamic` of `tests/torch_quality_reference.json`), on the mean over
the K input-noise draws as `vstab_torch.eval.quality.hold_gates` sets out.

On this clip the JAX package's robust pooling beats mean pooling by 0.126
on the mean over the draws; on the numpy-drawn clip by -0.001. The gate
moves with the drawing, for the reference as for the port.
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
SEC = REF["opencv_dynamic"]
GATES = [g["name"] for g in SEC["gates"]]


@pytest.fixture(scope="module")
def rows():
    cv2 = pytest.importorskip("cv2")
    if cv2.__version__ != SEC["cv2"]:
        pytest.skip(f"the JAX package's readings are of the clip OpenCV {SEC['cv2']} draws; "
                    f"OpenCV {cv2.__version__} draws another")
    from vstab.eval.synthetic import make_dynamic_clip

    fn, kw = REF["settings"]["gate_clips"][SEC["clip"]]
    assert fn == "make_dynamic_clip"
    clip = make_dynamic_clip(**kw)
    quality.check_clips([clip[0]], [SEC["clip_sum"]], [SEC["clip_sample"]], "the OpenCV-drawn dynamic clip")
    ref = {**REF, "gates": {**REF["gates"], "list": SEC["gates"]}}
    params = default_params(quality.config({}, "float32"), ckpt_dir=os.path.join(REPO, "ckpts"), device="cpu")
    readings = quality.gate_readings(ref, params, "float32", "cpu", runs=list(SEC["float32"]["runs"]),
                                     clips={SEC["clip"]: clip})
    return {r["gate"]: r for r in quality.hold_gates(ref, readings, "float32")}


@pytest.mark.parametrize("gate", GATES)
def test_gate_on_the_opencv_drawn_clip(rows, gate, capsys):
    row = rows[gate]
    with capsys.disabled():
        print(f"\n{json.dumps(row)}")
    assert row["ok"], row
