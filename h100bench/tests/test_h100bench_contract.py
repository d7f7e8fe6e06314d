"""BENCHMARK.json against the benchmark's contract, discovery by name, a
dummy cell added from files alone, and the result line's keys."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from h100bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert os.path.isfile(os.path.join(harness.ROOT, BENCH["command"][1]))
    assert BENCH["command"][1].startswith("h100bench/")


def test_run_seconds_fits_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_only_the_contracts_keys(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) <= keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)


def test_metrics_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_every_cell_reports_setup_another_rate_and_a_layer():
    cells = [w["name"] for w in BENCH["workloads"]]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)
    for c in cells:
        cell = harness.Cell.find(c, BENCH)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, c
        assert cell.per_layer, c
        assert cell.config and cell.traffic and cell.spec["entry"]


def test_configs_lie_under_paths_and_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("h100bench/") and c["name"] in used
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    read = harness.metric_reader(metric)
    assert read({}) is None and read(None) is None


def test_a_cell_config_and_metric_added_from_files_alone_are_found(tmp_path):
    """A later PR adds files and entries; no file that exists is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "h100bench"), root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "h100bench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    (root / "h100bench/configs/dummy_config.json").write_text(json.dumps(
        {"name": "dummy_config", "program": {}, "reduced": []}))
    (root / "h100bench/traffic/dummy_traffic.json").write_text(json.dumps(
        {"generator": "shaky_clips", "clips": 1, "frames": 3, "height": 8, "width": 8,
         "dtype": "float32", "place": "device", "walk_px": 3.0, "shake_px": 6.0,
         "shake_angle": 0.01}))
    (root / "h100bench/workloads/dummy_cell.json").write_text(json.dumps(
        {"entry": "stabilize", "check_clips": 1, "trace_clips": 1, "limits": {}}))
    (root / "h100bench/metrics/dummy_metric.py").write_text("def read(ctx):\n    return 1.5\n")
    bench["configs"].append({"name": "dummy_config", "source": "https://example.org",
                             "file": "h100bench/configs/dummy_config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                               "traffic": "dummy_traffic", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "flow", "moves": "setup_s",
                               "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "from h100bench import harness\n"
        "c = harness.Cell.find('dummy_cell')\n"
        "assert c.config['name'] == 'dummy_config' and c.traffic['frames'] == 3\n"
        "assert [m['name'] for m in c.per_layer] == ['dummy_metric']\n"
        "assert harness.metric_reader('dummy_metric')({}) == 1.5\n"
        "assert harness.driver(c.spec['entry']).run\n"
        "assert harness.generator(c.traffic['generator']).generate\n"
        "print('found')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root)}, timeout=120)
    assert out.returncode == 0 and "found" in out.stdout, out.stderr
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = harness.Cell.find("stab_720p_whole")
    run = harness.Run(cell=cell, seed=1, seconds=1.0, trace=trace, device=None, t_start=0.0)
    ctx = {"spans": {"flow": [0.2], "smooth": [0.01], "render": [0.03]},
           "window": {"seconds": 2.0, "flops": 1e12, "peak_flops": 989e12},
           "profile": {"busy_s": 0.8, "window_s": 1.0, "kernel_bound_s": 0.001,
                       "kernel_device_s": 0.002, "kernel_launches": 40,
                       "device_ops": [["k", 0.5]], "idle_gaps": [["aten::item", 0.1]]}}
    out = harness.Outcome(e2e={"frames_per_s": 170.0, "clip_p90_ms": 280.0, "setup_s": 12.0},
                          attempted=5, failed=0, checks={"frame_mad": harness.check(1e-3, 1e-2)},
                          memory_peak_bytes=123, trace=ctx if trace else None)
    line = harness.result_line(run, out, {"platform": "gpu", "kind": "x", "count": 1,
                                          "memory_peak_bytes": 123})
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and line["correct"] is True
    assert ("breakdown" in line) == trace
    names = set(line["metrics"])
    if trace:
        assert names == {m["name"] for m in cell.per_layer}
        assert line["metrics"]["kernel_roofline.720p"]["value"] == pytest.approx(50.0)
        assert line["metrics"]["device_idle.720p"]["value"] == pytest.approx(20.0)
    else:
        assert names == {"frames_per_s", "clip_p90_ms", "setup_s"}
    json.dumps(line)
