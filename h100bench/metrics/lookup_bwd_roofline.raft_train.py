"""lookup_bwd_roofline.raft_train: % of the roofline reached by the correlation lookup's backward: its launches' least time in the profiled section (`counts/raft_train.py`: bytes over the HBM rate) over the profiler's device time of the backward kernel."""


def read(ctx):
    prof = (ctx or {}).get("profile")
    if not prof or not prof.get("lookup_bwd_device_s") or not prof.get("lookup_bwd_launches"):
        return None
    return 100.0 * prof["lookup_bwd_bound_s"] / prof["lookup_bwd_device_s"]
