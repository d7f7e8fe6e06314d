"""Discovery by name, the run's context, and its result line."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that no run may hold once its window has closed:
# JAX, its libraries, and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vstab")


def load_json(kind: str, name: str) -> Dict[str, Any]:
    """`h100bench/<kind>/<name>.json`."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metric_reader(name: str) -> Callable:
    """The `read(ctx)` of `h100bench/metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(entry: str):
    return importlib.import_module(f"h100bench.drivers.{entry}")


def generator(name: str):
    return importlib.import_module(f"h100bench.generators.{name}")


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules that this process holds."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """One cell of BENCHMARK.json with its files."""

    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    spec: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @staticmethod
    def find(name: str, bench: Optional[Mapping] = None) -> "Cell":
        bench = benchmark() if bench is None else bench
        row = next((w for w in bench["workloads"] if w["name"] == name), None)
        if row is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")

        def mine(m):
            return name in m.get("workloads", [name])

        return Cell(
            name=name,
            config=load_json("configs", row["config"]),
            traffic=load_json("traffic", row["traffic"]),
            spec=load_json("workloads", name),
            chips=int(row["chips"]),
            end_to_end=[m for m in bench["end_to_end"] if mine(m)],
            per_layer=[m for m in bench["per_layer"] if mine(m)],
        )


@dataclasses.dataclass
class Run:
    """What a driver is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    params: Optional[Dict[str, Any]] = None  # tests pass weights; runs load the checkpoint

    def say(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver returns: end-to-end values by name, what it attempted and
    what failed, each compared number with its limit, the device's peak
    memory, and with a trace the per-layer readers' context."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int
    trace: Optional[Dict[str, Any]] = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c["value"] <= c["limit"] for c in self.checks.values())


def check(value: float, limit: float) -> Dict[str, float]:
    return {"value": float(value), "limit": float(limit)}


def power_limit() -> str:
    """The first card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"


def result_line(run: Run, out: Outcome, device: Mapping) -> Dict[str, Any]:
    """The line the run prints last, metrics in BENCHMARK.json's order."""
    metrics = {}
    if run.trace:
        for m in run.cell.per_layer:
            value = metric_reader(m["name"])(out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    line: Dict[str, Any] = {
        "correct": out.correct, "attempted": out.attempted, "failed": out.failed,
        "metrics": metrics, "device": dict(device),
    }
    if run.trace and out.trace and out.trace.get("profile"):
        prof = out.trace["profile"]
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["checks"] = out.checks
    return line


def elapsed(t0: float) -> float:
    return time.perf_counter() - t0
