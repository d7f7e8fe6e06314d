"""attn_roofline.gmflow: % of the roofline reached by GMFlow's attention and matchings in the profiled section: the least time of the spans' attn_flops at the bf16 peak (989 TFLOP/s) and match_flops + prop_flops at the f32 peak (67 TFLOP/s), over the profiler's device time of the kernels launched inside scaled_dot_product_attention and inside the match and propagate spans."""


def read(ctx):
    prof = (ctx or {}).get("profile")
    if not prof or not prof.get("attn_device_s") or not prof.get("attn_bound_s"):
        return None
    return 100.0 * prof["attn_bound_s"] / prof["attn_device_s"]
