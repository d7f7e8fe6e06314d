"""Reads a `torch.profiler` chrome trace: the device's busy time (the union
of its kernel, copy and set intervals), its time by kernel name, and the
longest idle gaps named by what the host was doing meanwhile."""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
WINDOW = "h100bench.window"  # the span around a traced section


def _merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _Host:
    """Host events sorted by start, to name what the host did in a gap."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: e[0])
        self.starts = [e[0] for e in self.ev]
        self.longest = max((e[1] - e[0] for e in self.ev), default=0.0)

    def best(self, a: float, b: float) -> Optional[str]:
        """The innermost event that covers at least half of the most that any
        event covers of [a, b]."""
        lo = bisect.bisect_left(self.starts, a - self.longest)
        hi = bisect.bisect_right(self.starts, b)
        cands = []
        for s, e, name in self.ev[lo:hi]:
            ov = min(e, b) - max(s, a)
            if ov > 0:
                cands.append((ov, e - s, name))
        if not cands:
            return None
        top = max(c[0] for c in cands)
        return min((c for c in cands if c[0] >= 0.5 * top), key=lambda c: c[1])[2]


def summarize(path: str, window: Optional[Tuple[float, float]] = None, n_top: int = 10) -> Optional[Dict]:
    """{'busy_s', 'window_s', 'by_name': {name: [seconds, count]},
    'device_ops': [[name, s]] (the n_top longest by total), 'idle_gaps':
    [[what the host did, s]] (the n_top longest gaps)} of the trace at
    `path`, or None when it holds no device event. The window is the span
    WINDOW that `record` puts around the run, else [first, last] event of
    any kind, unless given (in the trace's microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, spans, every = [], [], [], []
    by_name: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        every.append((a, b))
        if cat in DEVICE_CATS and b > a:
            dev.append((a, b))
            rec = by_name.setdefault(e["name"], [0.0, 0])
            rec[0] += (b - a) / 1e6
            rec[1] += 1
        elif cat in HOST_CATS:
            host.append((a, b, e["name"]))
        elif cat == SPAN_CAT:
            spans.append((a, b, e["name"]))
            if e["name"] == WINDOW and window is None:
                window = (a, b)
    if not dev:
        return None
    w0, w1 = window if window is not None else (min(a for a, _ in every), max(b for _, b in every))
    busy = _merge([(max(a, w0), min(b, w1)) for a, b in dev if b > w0 and a < w1])
    gaps = [(w0, busy[0][0])] + [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.append((busy[-1][1], w1))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:n_top]
    hosts, marks = _Host(host), _Host(spans)

    def what(a, b):
        op, span = hosts.best(a, b), marks.best(a, b)
        return " / ".join(x for x in (span, op) if x) or "no host event"

    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "by_name": by_name,
        "device_ops": [[name, rec[0]] for name, rec in top_ops],
        "idle_gaps": [[what(a, b), (b - a) / 1e6] for a, b in gaps],
    }


def record(run, path: str) -> None:
    """Runs `run()` under torch.profiler (host and CUDA activity) inside the
    span WINDOW and writes the chrome trace to `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
