"""What the RAFT training cell's span readers share: a span's stream ms
summed over each profiled training step, whichever thread recorded it (the
backward's spans are autograd's, outside the step's tree of spans)."""

from __future__ import annotations

import statistics
from typing import Mapping, Optional

STEP = "vstab.train.step"


def per_step_ms(ctx: Mapping, name: str) -> Optional[float]:
    """Median over the profiled steps of the stream ms of the spans `name`
    that began inside the step's span on the host's clock, summed; None
    where the run recorded no such span (a program without them)."""
    if not (ctx or {}).get("profile"):
        return None
    try:
        from vstab_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    recs = trace.records()
    steps = [(r["start_ns"], r["end_ns"]) for r in recs if r["name"] == STEP]
    spans = [(r["start_ns"], r["device_ms"]) for r in recs if r["name"] == name and r["device_ms"] is not None]
    if not steps or not spans:
        return None
    return statistics.median(sum(ms for t, ms in spans if a <= t <= b) for a, b in steps)
