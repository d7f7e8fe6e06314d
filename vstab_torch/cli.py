"""Command-line interface of the port, the counterpart of `vstab/cli.py`.

  python -m vstab_torch stabilize in.mp4 out.mp4 [--config cfg.json] [--crop auto]
  python -m vstab_torch eval [--dataset DIR] [--results results.jsonl] [--n-synthetic 8]
  python -m vstab_torch bench [--frames 48 --height 720 --width 1280]

A thin shell over the library: config JSON round-trips through
`core.config.Config`, videos go through `io/video.py` (OpenCV, host side), and
all compute runs on the CUDA device, or with `--device cpu` on the CPU through
the kernels' plain versions. Without a CUDA device the default `--device cuda`
exits with an error; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time

log = logging.getLogger("vstab_torch.cli")


def _load_config(args):
    from vstab_torch.core.config import Config, preset

    if getattr(args, "preset", None):
        cfg = preset(args.preset)
    elif getattr(args, "config", None):
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    if getattr(args, "crop", None):
        cfg = dataclasses.replace(
            cfg, render=dataclasses.replace(cfg.render, crop_mode=args.crop)
        )
    if getattr(args, "method", None):
        cfg = dataclasses.replace(
            cfg, smooth=dataclasses.replace(cfg.smooth, method=args.method)
        )
    return cfg


def _probe_frame_count(path: str, max_frames) -> int:
    """Container-reported frame count (0 if unknown) capped at max_frames."""
    from vstab_torch.io.video import probe_video

    n = probe_video(path)[0]
    if max_frames is not None:
        n = min(n, max_frames) if n > 0 else max_frames
    return n


def cmd_stabilize(args) -> int:
    from vstab_torch.io.video import read_video, write_video
    from vstab_torch.pipeline import default_params, resolve_device, stabilize

    cfg = _load_config(args)
    dev = resolve_device(args.device)
    # Probe the input before the parameters load, so a bad path fails at once.
    n_frames = _probe_frame_count(args.input, args.max_frames)
    params = default_params(cfg, ckpt_dir=args.ckpt_dir, device=dev)

    if args.blocked or n_frames > (cfg.dist.time_block_len * 4):
        # Long clip: temporal-block streaming, constant host and device
        # memory, file to file, never loading the whole clip.
        from vstab_torch.pipeline_blocked import stabilize_video_blocked

        stats = stabilize_video_blocked(
            args.input, args.output, params, cfg,
            block_len=args.block_len, max_frames=args.max_frames,
            resume=not args.no_resume, device=dev,
        )
        print(json.dumps(stats))
        return 0

    frames, fps = read_video(args.input, max_frames=args.max_frames)
    log.info("read %s: %s frames %sx%s @ %.1f fps", args.input, *frames.shape[:3], fps)
    t0 = time.perf_counter()
    out, _ = stabilize(frames, params, cfg, device=dev)
    out = out.cpu().numpy()  # waits for the device
    wall = time.perf_counter() - t0
    log.info("stabilized %d frames in %.2fs (%.1f frames/s)",
             frames.shape[0], wall, frames.shape[0] / wall)
    write_video(args.output, out, fps, codec=cfg.io.output_codec)
    print(json.dumps({
        "input": args.input, "output": args.output,
        "frames": int(frames.shape[0]),
        "fps_processed": round(frames.shape[0] / wall, 2),
    }))
    return 0


def cmd_eval(args) -> int:
    from vstab_torch.eval.deepstab import aggregate, report_table, run_sweep

    results = run_sweep(
        args.dataset,
        args.results,
        cfg=_load_config(args),
        n_synthetic=args.n_synthetic,
        max_frames=args.max_frames,
        synth_shape=tuple(args.synth_shape),
        data_parallel=args.data_parallel,
        save_videos_dir=args.save_videos,
        device=args.device,
    )
    print(report_table(results))
    print(json.dumps({"aggregate": aggregate(results)}))
    return 0


def main(argv=None) -> int:
    from vstab_torch import bench

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    ap = argparse.ArgumentParser(prog="vstab_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("stabilize", help="stabilize a video file")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--config", help="config JSON (core.config.Config)")
    sp.add_argument("--preset", help="milestone preset name (core.config)")
    sp.add_argument("--crop", choices=["fixed", "auto", "none"])
    sp.add_argument("--method", choices=["affine", "sparse_ls"])
    sp.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    sp.add_argument("--max-frames", type=int, default=None)
    sp.add_argument("--ckpt-dir", default="ckpts")
    sp.add_argument("--blocked", action="store_true",
                    help="force temporal-block streaming execution")
    sp.add_argument("--block-len", type=int, default=None,
                    help="temporal block length (frames) for the streaming "
                    "path; default cfg.dist.time_block_len")
    sp.add_argument("--no-resume", action="store_true",
                    help="disable the <out>.resume/ block-level checkpoint "
                    "of the streaming path")
    sp.set_defaults(fn=cmd_stabilize)

    ep = sub.add_parser("eval", help="metric sweep over a dataset")
    ep.add_argument("--dataset", default=None,
                    help="DeepStab-layout dir; synthetic fallback if unset")
    ep.add_argument("--results", default="results.jsonl")
    ep.add_argument("--config", help="config JSON")
    ep.add_argument("--preset")
    ep.add_argument("--crop", choices=["fixed", "auto", "none"])
    ep.add_argument("--method", choices=["affine", "sparse_ls"])
    ep.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ep.add_argument("--n-synthetic", type=int, default=8)
    ep.add_argument(
        "--synth-shape", type=int, nargs=3, default=(48, 256, 320),
        metavar=("T", "H", "W"),
        help="synthetic-fallback clip shape (contract-scale sweeps: "
        "48 720 1280 / 48 1080 1920)",
    )
    ep.add_argument("--max-frames", type=int, default=None)
    ep.add_argument("--data-parallel", action="store_true",
                    help="batch same-shape clips through stabilize_batch, one "
                    "device's worth (one clip) at a time; nothing is sharded")
    ep.add_argument("--save-videos", default=None)
    ep.set_defaults(fn=cmd_eval)

    bp = sub.add_parser("bench", help="throughput of stabilize on the card (vstab_torch/bench.py)")
    bench.add_arguments(bp)
    bp.set_defaults(fn=bench.run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
