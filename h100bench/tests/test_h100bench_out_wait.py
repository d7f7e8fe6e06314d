"""`out_wait_ms_per_frame.blocked` on made-up contexts: it reads the stats'
`host_s.out_wait` only where every call's stats carry `prefault_bytes`, so a
program without the faulting helper reads nothing."""

import pytest

from h100bench import harness

NAME = "out_wait_ms_per_frame.blocked"
HOST = ("prefetch_wait", "staging_wait", "stage_copy", "dispatch", "pinned_alloc", "fetch_wait",
        "drain_copy")


def _stats(frames, out_wait=None, prefault_bytes=None):
    s = {"frames": frames, "stage_s": {"flow": 1.0, "scale": 0.1, "render": 1.0},
         "host_s": dict.fromkeys(HOST, 0.25), "pinned_bytes": 31_200_000 * frames}
    if out_wait is not None:
        s["host_s"]["out_wait"] = out_wait
    if prefault_bytes is not None:
        s["prefault_bytes"] = prefault_bytes
    return s


def test_it_is_an_entry_of_the_blocked_cell():
    (m,) = [m for m in harness.benchmark()["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["stab_1080p_blocked"] and m["moves"] == "blocked_frames_per_s"
    assert (m["layer"], m["source"], m["better"], m["unit"]) == (
        "blocked pipeline", "program_span", "lower", "ms")


def test_it_sums_over_the_window_and_divides_by_its_frames():
    ctx = {"blocked_stats": [_stats(256, 0.5, 6_370_099_200), _stats(256, 0.25, 6_370_099_200)]}
    assert harness.metric_reader(NAME)(ctx) == pytest.approx(1e3 * 0.75 / 512)


@pytest.mark.parametrize("stats", [
    [_stats(256)],  # the parent: host_s without out_wait, no prefault_bytes
    [_stats(256, 0.5, 6_370_099_200), _stats(256)],  # one call without the key
    [{"frames": 256, "stage_s": {"flow": 1.0, "scale": 0.1, "render": 1.0}}],  # before host_s
    [],
])
def test_it_reads_nothing_without_prefault_bytes(stats):
    assert harness.metric_reader(NAME)({"blocked_stats": stats}) is None
    assert harness.metric_reader(NAME)({}) is None
