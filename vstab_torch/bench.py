"""Throughput of `vstab_torch.stabilize` on one NVIDIA card.

    python -m vstab_torch bench [--frames 48 --height 720 --width 1280 --iters 3 --stages]

synthesizes the clip `make_shaky_clip(t, h, w, seed=0)`, loads the weights of
`ckpts/` (under the working directory) into the default `Config`, runs
`stabilize` once to warm up and then `iters` times, each between two
`torch.cuda.synchronize()` calls on the host's clock, and prints one JSON
line with the median:

  {"metric": "stabilize_720p_fps", "value": N, "unit": "frames/s",
   "device": "<card name>, <power limit>"}

With `--stages` the flow / smooth / render times of one more run, read from
its spans (`vstab_torch.utils.trace`), go to stderr as one JSON line. There is no CPU mode: without a CUDA device it
raises, because a time taken on the CPU says nothing about the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from vstab_torch.core.config import Config
from vstab_torch.pipeline import Params, default_params, resolve_device, stabilize
from vstab_torch.utils import trace


def card() -> str:
    """The first card's name and power limit, as `nvidia-smi` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def timed(fn):
    """(fn(), seconds on the host's clock between two device synchronizations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def measure(
    frames: torch.Tensor, params: Params, cfg: Config, iters: int = 3, stages: bool = False
) -> dict:
    """One warm run of `stabilize` on CUDA frames [T,H,W,3], then `iters`
    timed ones: {"frames_per_s" (from the median run), "run_s" (every run),
    "peak_mem_gb"}, and with `stages` the stream ms of flow (`vstab.flow`),
    smooth (`vstab.smooth` + `vstab.bucket`: solve, bound and bucket) and
    render (`vstab.warp_field` + `vstab.render`) in one more run recorded by
    `trace`, with the bound, the bucket and the flow net's `aligned_pad`."""
    if not frames.is_cuda:
        raise RuntimeError("bench.measure times the CUDA path: give it frames on the card")
    t = frames.shape[0]
    torch.cuda.reset_peak_memory_stats()
    stabilize(frames, params, cfg)
    runs = [timed(lambda: stabilize(frames, params, cfg))[1] for _ in range(iters)]
    res = {
        "frames_per_s": t / statistics.median(runs),
        "run_s": runs,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if stages:
        with trace.recording():
            stabilize(frames, params, cfg)
        recs = trace.records()
        root = next(r["id"] for r in reversed(recs) if r["name"] == "vstab.stabilize")
        ms: dict = {}
        for r in recs:
            if r["root"] == root and r["device_ms"] is not None:
                ms[r["name"]] = ms.get(r["name"], 0.0) + r["device_ms"]
        # no bucket where cfg.render.adaptive_max_disp is off
        bucket = next((r["attrs"] for r in recs if r["root"] == root and r["name"] == "vstab.bucket"), {})
        flow = next(r["attrs"] for r in recs if r["root"] == root and r["name"] == "vstab.flow")
        res.update(
            flow_ms=ms["vstab.flow"],
            smooth_ms=ms["vstab.smooth"] + ms.get("vstab.bucket", 0.0),
            render_ms=ms["vstab.warp_field"] + ms["vstab.render"],
            residual_bound_px=bucket.get("bound_px"),
            max_disp=bucket.get("max_disp"),
            aligned_pad=flow.get("aligned_pad"),
        )
    return res


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--stages", action="store_true", help="also time each stage (stderr)")


def run(args) -> int:
    from vstab_torch.eval.synthetic import make_shaky_clip

    dev = resolve_device(None)
    cfg = Config()
    params = default_params(cfg)
    frames, _ = make_shaky_clip(t=args.frames, h=args.height, w=args.width, seed=0)
    res = measure(torch.from_numpy(frames).to(dev), params, cfg, args.iters, args.stages)
    device = card()
    if args.stages:
        print(json.dumps({"stages": {k: v for k, v in res.items() if k != "frames_per_s"},
                          "device": device}), file=sys.stderr)
    print(json.dumps({
        "metric": f"stabilize_{args.height}p_fps", "value": round(res["frames_per_s"], 3),
        "unit": "frames/s", "device": device,
    }))
    return 0
