"""The flow the stabilizer consumes, held to the JAX package on the CPU.

- The EPE gates of tests/integration/test_trained.py:81-101 on the port's
  own `eval_epe` (`flow_086000`, f32, 8 held-out pairs at 192x256, the port's
  own draws): under 1.2 px in family, 1.0 px on perlin, 2.2 px with
  occluders.
- bf16 flow, the card's default precision: on two clips of the eval set
  (48x256x320) the port's bf16 `clip_flow` (the plain versions) lies no
  further from the JAX package's f32 flow than 1.5x the JAX package's own
  bf16 flow does (`tests/torch_quality_reference.json`), in mean end-point
  distance and in the share of pixels over 0.5 px.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_quality_reference as jref
from vstab_torch.core.config import FlowConfig
from vstab_torch.eval import quality
from vstab_torch.flow.train import eval_epe
from vstab_torch.pipeline import clip_flow, default_params

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = quality.load_reference(os.path.join(REPO, "tests", "torch_quality_reference.json"))
PARITY = REF["eval_set"]["bf16_flow_vs_f32"]


@pytest.mark.parametrize("gate", REF["epe"], ids=[g["name"] for g in REF["epe"]])
def test_epe_gate(gate, capsys):
    params = default_params(quality.config({}, "float32"), ckpt_dir=os.path.join(REPO, "ckpts"), device="cpu")
    got = eval_epe(params, FlowConfig(compute_dtype="float32"), hw=(192, 256), n=8, kinds=tuple(gate["kinds"]),
                   occluders=gate["occluders"], device="cpu")
    with capsys.disabled():
        print(f"\nEPE {gate['name']}: port {got:.4f} px, JAX {gate['epe_px']:.4f} px, gate < {gate['threshold']}")
    assert got < gate["threshold"], (got, gate)


@pytest.fixture(scope="module")
def clips():
    return dict(quality.eval_clips(REF, max(jref.FLOW_PARITY_CLIPS) + 1))


@pytest.mark.parametrize("name", sorted(PARITY))
def test_bf16_flow_is_as_close_to_the_jax_f32_flow_as_the_jax_bf16_flow(clips, name, capsys):
    frames = clips[name]
    want = np.asarray(jref.clip_flow_of(jnp.asarray(frames), "float32"))
    cfg = quality.config({}, "bfloat16")
    params = default_params(cfg, ckpt_dir=os.path.join(REPO, "ckpts"), device="cpu")
    got = clip_flow(params, torch.from_numpy(frames), cfg).float().numpy()
    mine, theirs = jref.flow_distance(got, want), PARITY[name]
    with capsys.disabled():
        print(f"\n{name} bf16 flow against the JAX f32 flow: port {json.dumps(mine)}, JAX {json.dumps(theirs)}")
    assert mine["mean_px"] <= 1.5 * theirs["mean_px"], (mine, theirs)
    assert mine["share_over_half_px"] <= 1.5 * theirs["share_over_half_px"], (mine, theirs)
