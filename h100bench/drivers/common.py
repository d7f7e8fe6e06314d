"""What the drivers share: weights, the kernels' build, the traced section."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from h100bench import harness, trace_read, weights
from h100bench.counts import kernels as kernel_counts

# Name prefixes of the program's CUDA kernels in the profiler's trace.
PORT_KERNELS = ("cost_volume_", "bilinear_warp_", "vwarp_", "hwarp_")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(cfg: Dict):
    """The program's Config from the configuration file's 'program' group."""
    from vstab_torch.core.config import Config

    return Config.from_json(json.dumps(cfg["program"]))


def params(run: harness.Run) -> Dict[str, torch.Tensor]:
    """The configuration's checkpoint as a float32 state dict on the device
    (a test may pass its own)."""
    if run.params is not None:
        return {k: v.to(run.device) for k, v in run.params.items()}
    return weights.load(os.path.join(harness.ROOT, run.cell.config["checkpoint"]), run.device)


def build(device) -> None:
    """The program's kernels, built into its fixed build directory once per checkout."""
    if device.type == "cuda":
        from vstab_torch.kernels import _build

        _build.build_all()


@contextlib.contextmanager
def recorded_launches():
    """Every launch of the program's CUDA kernels in the block, as (entry
    point, arguments)."""
    from vstab_torch.kernels._build import CudaKernel

    calls: List = []
    orig = CudaKernel.__call__

    def call(self, *args):
        calls.append((self.symbol, args))
        return orig(self, *args)

    CudaKernel.__call__ = call
    try:
        yield calls
    finally:
        CudaKernel.__call__ = orig


def profiled(run_fn: Callable[[], None]) -> Optional[Dict]:
    """`run_fn` once under the profiler, with the program's kernel launches
    recorded: the trace's summary plus 'kernel_bound_s' (the launches' least
    time on the card) and 'kernel_device_s' (the profiler's time of the
    program's kernels), or None without device events."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="h100bench_trace_")
    os.close(fd)
    try:
        with recorded_launches() as calls:
            trace_read.record(run_fn, path)
        summary = trace_read.summarize(path)
    finally:
        os.remove(path)
    if summary is None:
        return None
    summary["kernel_bound_s"] = sum(kernel_counts.bound_s(s, a) for s, a in calls)
    summary["kernel_launches"] = len(calls)
    summary["kernel_device_s"] = sum(
        s for name, (s, _) in summary["by_name"].items() if any(k in name for k in PORT_KERNELS)
    )
    summary["kernel_events"] = sum(
        n for name, (_, n) in summary["by_name"].items() if any(k in name for k in PORT_KERNELS)
    )
    del summary["by_name"]
    return summary


def timed_stages(device, stages: Dict[str, Callable], spans: Dict[str, List[float]], state: Dict):
    """Runs the stages in order, each between two device synchronisations on
    the host's clock; each takes and updates `state`."""
    for name, fn in stages.items():
        sync(device)
        t0 = time.perf_counter()
        fn(state)
        sync(device)
        spans.setdefault(name, []).append(time.perf_counter() - t0)
