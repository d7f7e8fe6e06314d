"""corr_lookup_roofline.raft: % of the roofline reached by the correlation lookup: its launches' least time in the profiled section (`counts/raft.py`: bytes over the HBM rate) over the profiler's device time of the lookup kernel."""


def read(ctx):
    prof = (ctx or {}).get("profile")
    if not prof or not prof.get("lookup_device_s") or not prof.get("lookup_launches"):
        return None
    return 100.0 * prof["lookup_bound_s"] / prof["lookup_device_s"]
