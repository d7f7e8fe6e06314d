"""Times RAFT's correlation-lookup backward at the `train_raft_chairs` cell's shape on the card: the CUDA kernel
(`corr_lookup_backward`), the plain route (autograd of `grid_sample`) and the forward in float32, with CUDA events,
beside the launch's least time (its counted bytes over 3.35 TB/s) and the time to write the whole slices at that rate.

    python perf_records/lookup_bwd_timing.py        # one JSON line; needs a CUDA card
"""
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vstab_torch.kernels import corr_lookup, corr_lookup_backward, corr_lookup_plain  # noqa: E402
from vstab_torch.kernels.corr_lookup import lookup_bwd_bytes  # noqa: E402

HBM = 3.35e12


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


def main():
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, h, w = 10, 46, 62  # 10 pairs of 368x496 at 1/8
    pyr = [torch.randn((n * h * w, h, w), generator=g, device=dev)]
    for _ in range(3):
        pyr.append(F.avg_pool2d(pyr[-1][:, None], 2, stride=2)[:, 0].contiguous())
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    coords = (torch.stack([xx, yy], -1).float()[None].expand(n, h, w, 2)
              + 3.0 * torch.randn((n, h, w, 2), generator=g, device=dev)).contiguous()
    sizes = [tuple(p.shape[1:]) for p in pyr]
    grad = torch.randn((n, h, w, 324), generator=g, device=dev)
    leaves = [p.clone().requires_grad_(True) for p in pyr]
    out = corr_lookup_plain(leaves, coords, 4)
    row = {"shape": "10x46x62, levels to 5x7, r=4, flow +-3 px at 1/8",
           "kernel_ms": ms(lambda: corr_lookup_backward(grad, sizes, coords, 4), 50),
           "plain_ms": ms(lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True), 10),
           "forward_f32_ms": ms(lambda: corr_lookup(pyr, coords, 4), 50),
           "bound_ms": lookup_bwd_bytes(n * h * w, 4, 4) / HBM * 1e3,
           "slices_bytes": 4 * n * h * w * sum(a * b for a, b in sizes)}
    row["slices_ms_at_hbm"] = row["slices_bytes"] / HBM * 1e3
    print(json.dumps(row))


if __name__ == "__main__":
    main()
