"""No run imports JAX, its libraries or the JAX package, compared by whole
top-level names; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from h100bench import harness

HERE = os.path.join(harness.ROOT, "h100bench")


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = set(_imported_tops(path))
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
    if os.sep + "reference" + os.sep in path:
        assert "vstab_torch" not in tops


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vstab_torch_fake", object())
    assert "vstab" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "vstab.fake", object())
    assert harness.forbidden_loaded() == ["vstab"]


def test_a_run_of_the_harness_loads_no_forbidden_module():
    """The drivers, the program and the reference in one fresh process at a
    tiny size on the CPU, then the look that run.py makes."""
    code = (
        "import sys, time, torch\n"
        "from h100bench import harness\n"
        "from h100bench.tests import helpers\n"
        "cell, params = helpers.tiny_cell('stab_720p_whole', tiny_net=True)\n"
        "run = harness.Run(cell=cell, seed=3, seconds=0.2, trace=False,\n"
        "                  device=torch.device('cpu'), t_start=time.perf_counter(), params=params)\n"
        "harness.driver(cell.spec['entry']).run(run)\n"
        "import vstab_torch\n"
        "print('forbidden', harness.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": harness.ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "forbidden []" in out.stdout


def test_run_exits_without_a_result_where_there_is_no_program(tmp_path):
    """A directory with only BENCHMARK.json and h100bench/ is no checkout."""
    import shutil

    shutil.copytree(HERE, tmp_path / "h100bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "stab_720p_whole",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
