"""What the per-layer metric readers share. Each reader takes the traced
run's context (a driver's `Outcome.trace`) and returns a number, or None
when the context holds nothing for it; a share of a roofline or a peak is
never given as 0 for want of a reading."""

from __future__ import annotations

from typing import Mapping, Optional


def span_ms(ctx: Mapping, name: str) -> Optional[float]:
    """Mean milliseconds of the harness's span `name` over the traced run."""
    spans = (ctx or {}).get("spans", {}).get(name)
    return 1e3 * sum(spans) / len(spans) if spans else None


def kernel_roofline(ctx: Mapping) -> Optional[float]:
    """%: the least time of the program's kernel launches in the profiled
    section (bytes over the HBM rate or operations over the peak, the larger,
    a launch) over the profiler's device time of those kernels."""
    prof = (ctx or {}).get("profile")
    if not prof or not prof.get("kernel_device_s") or not prof.get("kernel_launches"):
        return None
    return 100.0 * prof["kernel_bound_s"] / prof["kernel_device_s"]


def mfu(ctx: Mapping) -> Optional[float]:
    """%: the window's operations (`counts.pwcnet`) over its seconds, against
    the configuration's peak."""
    win = (ctx or {}).get("window")
    if not win or not win.get("seconds") or not win.get("flops"):
        return None
    return 100.0 * win["flops"] / win["seconds"] / win["peak_flops"]


def device_idle(ctx: Mapping) -> Optional[float]:
    """%: the share of the profiled section in which the device ran nothing."""
    prof = (ctx or {}).get("profile")
    if not prof or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def blocked_stage_ms_per_frame(ctx: Mapping, stage: str) -> Optional[float]:
    """ms a frame of one sweep of the blocked pipeline, from the stats it
    logs at the end of every call in the window."""
    stats = (ctx or {}).get("blocked_stats")
    if not stats:
        return None
    return 1e3 * sum(s["stage_s"][stage] for s in stats) / sum(s["frames"] for s in stats)
