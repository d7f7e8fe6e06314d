"""The render's crop zoom on the card: its two-tap 1-D passes against the
dense tent products they replaced.

    python perf_records/zoom_passes.py

At each render dispatch of a benchmark cell (the whole 4K clip, 16x2160x3840;
the whole 720p clip, 48x720x1280; a 1080p block, 64x1080x1920), for the
frame (3 channels) and the validity mask (1), at the configurations' 0.9
crop, it times with CUDA events after a device spin (median of 10 calls,
2 warm-ups):

- `vwarp`, `hwarp`: the zoom's vertical and horizontal pass
  (`zoom_resample`'s two launches), beside each one's bound, the bytes
  `h100bench/counts/kernels.py` counts (frame and field read, output written)
  over 3.35 TB/s;
- `fields`: `zoom_fields`, the two [T,H,W] displacement fields a render call
  builds once for the frame and the mask;
- `tent`: the two dense [n,n] f32 products (TF32 off) of the renderer before.

Each pass's output is held against the tent product (largest error), and
for the mask of a shaken clip the `> 0.999` decisions that differ are
counted. Prints the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_zoom_tent import tent_zoom  # noqa: E402

from vstab_torch.kernels import hwarp, twopass_validity, vwarp  # noqa: E402
from vstab_torch.render.render import affine_to_flow, zoom_fields, zoom_resample  # noqa: E402

HBM = 3.35e12  # H100 SXM bytes/s
SHAPES = (("4k", (16, 2160, 3840)), ("720p", (48, 720, 1280)), ("1080p_block", (64, 1080, 1920)))


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


def _shaken_mask(t: int, h: int, w: int, g) -> torch.Tensor:
    """[T,H,W,1] validity of a clip shaken by up to 80 px and 0.01 rad, at the bucket 63."""
    ang = (torch.rand(t, generator=g, device="cuda") - 0.5) * 0.02
    cos, sin = torch.cos(ang), torch.sin(ang)
    shift = (torch.rand((t, 2), generator=g, device="cuda") - 0.5) * 160.0
    tr = torch.stack([torch.stack([cos, -sin, shift[:, 0]], -1), torch.stack([sin, cos, shift[:, 1]], -1)], 1)
    return twopass_validity((h, w), affine_to_flow(tr, h, w), 63)[..., None]


def main() -> int:
    if not torch.cuda.is_available():
        print("zoom_passes: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    s = torch.tensor(0.9, device="cuda")
    for name, (t, h, w) in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(24)
        fy, fx = zoom_fields((t, h, w), s)
        row = {"dispatch": name, "thw": [t, h, w], "fields_ms": round(_time_ms(lambda: zoom_fields((t, h, w), s)), 4)}
        for c in (3, 1):
            img = torch.rand((t, h, w, c), generator=g, device="cuda") if c == 3 else _shaken_mask(t, h, w, g)
            tmp = vwarp(img, fy, float(h), "edge")
            got = hwarp(tmp, fx, float(w), "edge")
            want = tent_zoom(img, s)
            err = float((got - want).abs().max())
            bound = t * h * w * (2 * c + 1) * 4 / HBM * 1e3
            row[f"c{c}"] = {
                "bound_ms": round(bound, 4),
                "vwarp_ms": round(_time_ms(lambda: vwarp(img, fy, float(h), "edge")), 4),
                "hwarp_ms": round(_time_ms(lambda: hwarp(tmp, fx, float(w), "edge")), 4),
                "zoom_ms": round(_time_ms(lambda: zoom_resample(img, s, (fy, fx))), 4),
                "tent_ms": round(_time_ms(lambda: tent_zoom(img, s), iters=5), 4),
                "max_abs_err": err,
            }
            if c == 1:
                row["c1"]["decisions_differ"] = int(((got > 0.999) != (want > 0.999)).sum())
                row["c1"]["invalid_px"] = int((want <= 0.999).sum())
            del img, tmp, got, want
        print(json.dumps(row), flush=True)
        del fy, fx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
