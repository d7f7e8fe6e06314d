"""Readers of what the program records itself: the blocked pipeline's
returned stats (`host_s`, `pinned_bytes`) and the spans of
`vstab_torch.utils.trace`. Each returns None when the context holds nothing
for it, as a program without these records gives."""

from __future__ import annotations

import statistics
from typing import Mapping, Optional, Sequence


def _blocked_stats(ctx: Mapping, key: str) -> Optional[list]:
    stats = (ctx or {}).get("blocked_stats")
    if not stats or any(key not in s for s in stats):
        return None
    return stats


def blocked_host_ms_per_frame(ctx: Mapping, keys: Sequence[str]) -> Optional[float]:
    """ms a frame of the blocked pipeline's per-block host spans `keys` (self
    time, the stats' `host_s`), over the window's calls."""
    stats = _blocked_stats(ctx, "host_s")
    if stats is None:
        return None
    return 1e3 * sum(s["host_s"][k] for s in stats for k in keys) / sum(s["frames"] for s in stats)


def blocked_pinned_mb_per_frame(ctx: Mapping) -> Optional[float]:
    """MB a frame of pinned host memory the window's blocked calls asked for."""
    stats = _blocked_stats(ctx, "pinned_bytes")
    if stats is None:
        return None
    return sum(s["pinned_bytes"] for s in stats) / 1e6 / sum(s["frames"] for s in stats)


def span_gpu_ms(ctx: Mapping, name: str) -> Optional[float]:
    """Median over the profiled section's spans `name` of the stream ms
    between their events. The program records spans only while the profiler
    runs, so the buffer holds that section alone."""
    if not (ctx or {}).get("profile"):
        return None
    try:
        from vstab_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    ms = [r["device_ms"] for r in trace.records() if r["name"] == name and r["device_ms"] is not None]
    return statistics.median(ms) if ms else None
