"""The eval sweep's scores on the CPU, held to the JAX package's: the first
12 clips of `synthetic_clip_set(N)` at 48x256x320 (every third with moving
occluders; drawn by the generator's numpy paths, as the reference's were),
`flow_086000`, the default Config with f32 flow, through
`stabilize`. The port's mean of each score over the 12 clips must lie within
the f32 tolerance for n = 12 of `tests/torch_quality_reference.json` of the
JAX package's mean over the same clips; the per-clip scores are printed.
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
N_CPU = 12


@pytest.fixture(scope="module")
def held():
    cfg = quality.config({}, "float32")
    params = default_params(cfg, ckpt_dir=os.path.join(REPO, "ckpts"), device="cpu")
    clips = quality.eval_clips(REF, N_CPU)
    assert [n for n, _ in clips] == REF["eval_set"]["clips"][:N_CPU]
    quality.check_clips([f for _, f in clips], REF["eval_set"]["clip_sums"][:N_CPU],
                        REF["eval_set"]["clip_samples"][:N_CPU], "eval set")
    recs = quality.clip_scores(clips, params, cfg, "cpu")
    ref_means = REF["eval_set"]["means"]["float32"][f"first_{N_CPU}"]
    rows = quality.hold_means(ref_means, quality.mean_scores(recs), REF, "float32", N_CPU)
    return {r["score"]: r for r in rows}, recs


@pytest.mark.parametrize("score", quality.SCORES)
def test_mean_over_the_clips_is_within_the_tolerance(held, score, capsys):
    rows, recs = held
    with capsys.disabled():
        print(f"\n{score} by clip, port / JAX: " + json.dumps(
            [[round(a[score], 4), round(b[score], 4)] for a, b in zip(recs, REF["eval_set"]["float32"])]))
        print(json.dumps(rows[score]))
    assert rows[score]["ok"], rows[score]
