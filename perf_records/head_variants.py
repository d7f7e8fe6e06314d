"""Forms of the flow networks' f32 prediction head, timed on the card.

    python perf_records/head_variants.py

The head is a 3x3, stride-1, 'SAME' f32 convolution from an estimator's
stack (565 to 725 channels, or the context network's 32) to 2 outputs.
At each shape of a 720p chunk of 8 pairs (the five estimator levels and the
context network's head) and at the 4K chunk's level 2 (2 pairs) it times,
with CUDA events after a device spin (median of 10 calls, 2 warm-ups):

- `program`: `vstab_torch.flow.layers.conv3x3_to2` (x @ Wk [C,18], F.fold);
- `pad24`, `pad32`: the same with Wk padded with zero columns to 24 or 32;
- `batched`: Wk^T [18,C] @ x^T per image, [N,18,HW] straight into F.fold
  (no transposed copy of the taps);
- `shift_add`: x @ Wk with taps unflipped, zero padding of the taps, then
  three strided adds along W and three along H;
- `cudnn`: cuDNN's f32 convolution on the channels-last input, TF32 off
  (its NHWC-to-NCHW relayout included), the path's form before the GEMM;
- `upcast`: the bf16 stack's `.float()`, which both forms read.

Each form is first held against `cudnn` (max error over max |out|). Then
the sums over a 720p clip (6 chunks) and a 4K clip (8 chunks) of the level
shapes' `program` and `cudnn` times. Prints the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vstab_torch.core.precision import pin_full_f32  # noqa: E402
from vstab_torch.flow import layers  # noqa: E402

HBM = 3.35e12  # H100 SXM bytes/s
F32 = 67e12  # H100 SXM f32 outside the tensor cores, flop/s
# (name, shape, chunks a clip): 720p chunk of 8 pairs, levels 2..6, context;
# 4K chunk of 2 pairs (2176x3840 padded), level 2..6.
SHAPES = (
    ("720p.l2", (8, 192, 320, 565), 6), ("720p.l3", (8, 96, 160, 597), 6),
    ("720p.l4", (8, 48, 80, 629), 6), ("720p.l5", (8, 24, 40, 661), 6),
    ("720p.l6", (8, 12, 20, 725), 6), ("720p.ctx", (8, 192, 320, 32), 6),
    ("4k.l2", (2, 544, 960, 565), 8), ("4k.l3", (2, 272, 480, 597), 8),
    ("4k.l4", (2, 136, 240, 629), 8), ("4k.l5", (2, 68, 120, 661), 8),
    ("4k.l6", (2, 34, 60, 725), 8), ("4k.ctx", (2, 544, 960, 32), 8),
)


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _wk(weight, cols):
    c = weight.shape[1]
    wk = weight.flip(2, 3).transpose(0, 1).reshape(c, 18)
    return F.pad(wk, (0, cols - 18)) if cols > 18 else wk


def padded(x, weight, bias, cols):
    n, h, w, c = x.shape
    z = x.reshape(n * h * w, c) @ _wk(weight, cols)
    y = F.fold(z.view(n, h * w, cols)[..., :18].transpose(1, 2), (h, w), kernel_size=3, padding=1)
    return y.permute(0, 2, 3, 1) + bias


def batched(x, weight, bias):
    n, h, w, c = x.shape
    z = torch.matmul(_wk(weight, 18).t(), x.view(n, h * w, c).transpose(1, 2))  # [N,18,HW]
    y = F.fold(z, (h, w), kernel_size=3, padding=1)
    return y.permute(0, 2, 3, 1) + bias


def shift_add(x, weight, bias):
    n, h, w, c = x.shape
    wk = weight.permute(1, 2, 3, 0).reshape(c, 18)  # [C, (i, j, out)], taps as gathered
    z = (x.reshape(n * h * w, c) @ wk).view(n, h, w, 3, 3, 2)
    zp = F.pad(z, (0, 0, 0, 0, 0, 0, 1, 1, 1, 1))  # zero row and column around the image
    r = zp[:, :, 0:w, :, 0] + zp[:, :, 1 : w + 1, :, 1] + zp[:, :, 2 : w + 2, :, 2]
    y = r[:, 0:h, :, 0] + r[:, 1 : h + 1, :, 1] + r[:, 2 : h + 2, :, 2]
    return y + bias


def main() -> int:
    if not torch.cuda.is_available():
        print("head_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    pin_full_f32()
    totals = {}
    for name, (n, h, w, c), chunks in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(20)
        xb = F.leaky_relu(torch.randn((n, h, w, c), generator=g, device="cuda", dtype=torch.bfloat16), 0.1)
        x = xb.float()
        head = layers.Conv(c, 2, dtype=torch.float32, device="cuda")
        head.reset_parameters(g)
        wt, b = head.weight.detach(), torch.randn(2, generator=g, device="cuda")
        forms = {
            "program": lambda: layers.conv3x3_to2(x, wt, b),
            "pad24": lambda: padded(x, wt, b, 24),
            "pad32": lambda: padded(x, wt, b, 32),
            "batched": lambda: batched(x, wt, b),
            "shift_add": lambda: shift_add(x, wt, b),
            "cudnn": lambda: F.conv2d(x.permute(0, 3, 1, 2), wt, b, padding=1).permute(0, 2, 3, 1),
        }
        with torch.no_grad():
            want = forms["cudnn"]()
            scale = float(want.abs().max())
            errs = {k: float((f() - want).abs().max()) / scale for k, f in forms.items() if k != "cudnn"}
            ms = {k: _time_ms(f) for k, f in forms.items()}
            ms["upcast"] = _time_ms(lambda: xb.float())
        nbytes = x.numel() * 4 + n * h * w * 2 * 4
        bound = max(nbytes / HBM, 2 * n * h * w * c * 18 / F32) * 1e3
        for k in ("program", "cudnn", "upcast"):
            totals.setdefault(name.split(".")[0], {}).setdefault(k, 0.0)
            totals[name.split(".")[0]][k] += chunks * ms[k]
        totals[name.split(".")[0]].setdefault("bound", 0.0)
        totals[name.split(".")[0]]["bound"] += chunks * bound
        print(json.dumps({"shape": name, "nhwc": [n, h, w, c], "bound_ms": round(bound, 4),
                          "ms": {k: round(v, 4) for k, v in ms.items()},
                          "max_err_over_max": {k: float(f"{v:.3g}") for k, v in errs.items()}}), flush=True)
        del x, xb, want
        torch.cuda.empty_cache()
    print(json.dumps({"ms_a_clip": {k: {m: round(v, 3) for m, v in t.items()} for k, t in totals.items()},
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
