"""Times RAFT's all-pairs correlation at the `stab_720p_raft` chunk's shape on the card (8 pairs of 256x90x160
bf16 features in channels-last memory, as `fnet` leaves them): the f32 route (both upcast, an f32 SGEMM with TF32
off, the division by sqrt(C)) and the bf16 route of `raft.corr_pyramid` (one bf16 x bf16 product with f32 sums, an
f32 volume and the scale in its alpha), each alone and with the pyramid's three poolings, with CUDA events, beside
the product's least time: its f32 volume written once at 3.35 TB/s, or its operations at the bf16 peak. It prints
each route's kernels (torch.profiler) and its largest error against a float64 product of the same features.

    python perf_records/corr_gemm_timing.py        # JSON lines; needs a CUDA card
"""
import json
import math
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vstab_torch.core.precision import pin_full_f32  # noqa: E402
from vstab_torch.flow import raft  # noqa: E402

HBM, BF16_PEAK = 3.35e12, 989e12


def ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def f32_product(f1, f2):
    """The f32 route's product, as `corr_pyramid` takes it for float32 features."""
    n, c, h, w = f1.shape
    a, b = (f.float().permute(0, 2, 3, 1).reshape(n, h * w, c) for f in (f1, f2))
    return torch.bmm(a, b.transpose(1, 2)).div_(math.sqrt(c))


def bf16_product(f1, f2):
    """The bf16 route's product, as in `corr_pyramid`."""
    n, c, h, w = f1.shape
    a, b = (f.permute(0, 2, 3, 1).reshape(n, h * w, c) for f in (f1, f2))
    corr = torch.empty((n, h * w, h * w), dtype=torch.float32, device=f1.device)
    return torch.baddbmm(corr, a, b.transpose(1, 2), out_dtype=torch.float32, beta=0,
                         alpha=1 / math.sqrt(c), out=corr)


def with_pools(product):
    def run(f1, f2):
        n, _, h, w = f1.shape
        pyr = [product(f1, f2).view(n * h * w, 1, h, w)]
        for _ in range(3):
            pyr.append(F.avg_pool2d(pyr[-1], 2, stride=2))
        return pyr
    return run


def kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.key[:110], round(e.device_time_total / 1e3, 4)] for e in prof.key_averages()
            if e.device_time_total > 0]


def error(product, f1, f2):
    """max |product - float64 product| over all pairs, and the same over the float64 volume's RMS."""
    got = product(f1, f2)
    c = f1.shape[1]
    worst, sq, count = 0.0, 0.0, 0
    for i in range(f1.shape[0]):
        a = f1[i].double().flatten(1)
        b = f2[i].double().flatten(1)
        want = a.T @ b / math.sqrt(c)
        worst = max(worst, float((got[i].double() - want).abs().max()))
        sq, count = sq + float(want.pow(2).sum()), count + want.numel()
        del want
    return worst, worst / math.sqrt(sq / count)


def main():
    pin_full_f32()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    n, c, h, w = 8, 256, 90, 160
    fmap = torch.randn((n + 1, c, h, w), generator=g, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last)
    f1, f2 = fmap[:-1], fmap[1:]
    assert raft.corr_gemm(f1, f2) == "bf16_f32acc"
    volume_bytes = 4 * n * (h * w) ** 2
    bound = {"write_ms": volume_bytes / HBM * 1e3, "ops_ms": 2 * n * (h * w) ** 2 * c / BF16_PEAK * 1e3}
    print(json.dumps({"shape": f"{n} pairs, {c}x{h}x{w} bf16", "volume_bytes": volume_bytes,
                      "bound_ms": bound}), flush=True)
    for name, product in (("f32", f32_product), ("bf16_f32acc", bf16_product)):
        row = {"route": name,
               "product_ms": ms(lambda: product(f1, f2), 20),
               "pyramid_ms": ms(lambda: with_pools(product)(f1, f2), 20)}
        row["product_over_bound"] = row["product_ms"] / bound["write_ms"]
        row["max_err"], row["max_err_over_rms"] = error(product, f1, f2)
        row["kernels"] = kernels(lambda: with_pools(product)(f1, f2))
        print(json.dumps(row), flush=True)
    got, want = raft.corr_pyramid(f1, f2, 4), with_pools(bf16_product)(f1, f2)
    print(json.dumps({"corr_pyramid_is_the_bf16_route": all(torch.equal(x.view_as(y), y)
                                                            for x, y in zip(got, want)),
                      "corr_pyramid_ms": ms(lambda: raft.corr_pyramid(f1, f2, 4), 20)}), flush=True)


if __name__ == "__main__":
    main()
