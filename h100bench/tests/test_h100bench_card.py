"""On the card, at each cell's own size: the control (the reference in the
program's place, one precision below what the configuration states) comes
out not correct under the cell's limits, on a seed no limit was set from;
the trainer's half-batch fault too. Skips without a card.

    python -m pytest h100bench/tests/test_h100bench_card.py -q -p no:cacheprovider
"""

import time

import pytest

from h100bench import control, harness, judge

SEED = 2**31 + 4242
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _records(name, device):
    cell = harness.Cell.find(name)
    run = harness.Run(cell=cell, seed=SEED, seconds=0.0, trace=False, device=device,
                      t_start=time.perf_counter())
    if cell.spec["entry"] == "train":
        return cell, list(control.trainer(run, [SEED], {SEED}))
    return cell, list(control.stabilizer(run, [SEED], {SEED}, blocked=cell.spec["entry"] == "blocked"))


def _correct(recs, limits):
    """As a run decides: each compared number's mean over the judged clips
    (or the one reading of the first steps) within its limit."""
    return all(c["value"] <= c["limit"] for c in judge.run_checks(recs, limits).values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_and_the_program_is(name, card):
    cell, recs = _records(name, card)
    limits = cell.spec["limits"]
    kinds = {}
    for r in recs:
        kinds.setdefault(r["who"].split(":")[0], []).append(r)
    assert {"program", "control"} <= set(kinds)
    assert _correct(kinds.pop("program"), limits)
    kinds.pop("repeat", None)  # two sound runs of the program
    for who, rs in kinds.items():
        assert not _correct(rs, limits), (who, rs)
