"""DeepStab/NUS evaluation harness, the port of `vstab/eval/deepstab.py`.

- enumerates clips from a dataset directory (DeepStab layout `unstable/`, or
  any flat directory of videos), falling back to N synthetic shaky clips when
  no dataset is on disk;
- runs the full pipeline per clip and computes the metric triple (stability,
  cropping, distortion: `eval/metrics.py`);
- appends one JSON line per clip to `results.jsonl` as it goes and skips the
  clips already there on a rerun. The records have the JAX package's keys, so
  a file written by either harness resumes under the other;
- aggregates a report table.

`run_sweep(..., data_parallel=True)` is the clip-level data-parallel sweep
(`_run_dp_batches`). With a process group up, every rank calls it with the
same arguments: rank 0 reads the manifest and tells the others what is done,
same-shape clips go in groups of as many clips as there are ranks, rank r
stabilizes clip r of a group on its own device, and the records gather on
rank 0, which alone appends them to the manifest. With no process group it
runs one clip at a time on the one device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".m4v")


def enumerate_clips(data_dir: str) -> List[str]:
    """Video files under `data_dir` (an `unstable/` subdirectory, the DeepStab
    layout, if there is one, else the directory itself), sorted."""
    sub = os.path.join(data_dir, "unstable")
    root = sub if os.path.isdir(sub) else data_dir
    if not os.path.isdir(root):
        return []
    return [
        os.path.join(root, f)
        for f in sorted(os.listdir(root))
        if f.lower().endswith(VIDEO_EXTS)
    ]


def synthetic_clip_set(
    n_clips: int, t: int = 48, h: int = 256, w: int = 320
) -> List[Tuple[str, np.ndarray]]:
    """Fallback dataset: named synthetic shaky clips. Every third clip has
    independently moving textured foreground occluders (`make_dynamic_clip`):
    a planar-only sweep would overstate the metrics."""
    return [synthetic_clip(i, t, h, w) for i in range(n_clips)]


def synthetic_clip(i: int, t: int = 48, h: int = 256, w: int = 320) -> Tuple[str, np.ndarray]:
    """Clip i of `synthetic_clip_set`: (name, frames)."""
    from vstab_torch.eval.synthetic import make_dynamic_clip, make_shaky_clip

    if i % 3 == 2:
        return f"synthetic_dyn_{i:03d}", np.asarray(make_dynamic_clip(t=t, h=h, w=w, seed=100 + i)[0])
    return f"synthetic_{i:03d}", np.asarray(make_shaky_clip(t=t, h=h, w=w, seed=100 + i)[0])


def _load_done(results_path: str) -> Dict[str, dict]:
    """Completed-clip records from the manifest. A record counts as done only
    if it parses and carries the metric payload: a torn tail line from a
    killed run, or half a record, is redone rather than trusted."""
    done = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and isinstance(rec.get("clip"), str) and "stability" in rec:
                    done[rec["clip"]] = rec
    return done


def _append_record(results_path: str, rec: dict) -> None:
    """Append one JSONL record, healing a torn tail first: a run killed in
    the middle of a write leaves a last line with no newline, and appending
    straight onto it would swallow this record into the garbage line."""
    need_nl = False
    try:
        with open(results_path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            need_nl = f.read(1) != b"\n"
    except OSError:  # missing file, or empty file (the negative seek raises)
        pass
    with open(results_path, "a") as f:
        if need_nl:
            f.write("\n")
        f.write(json.dumps(rec) + "\n")


def _iter_clips(
    data_dir: Optional[str],
    n_synthetic: int,
    max_frames: Optional[int],
    synth_shape: Tuple[int, int, int],
) -> Iterator[Tuple[str, np.ndarray, float]]:
    """Yields (name, frames [T,H,W,3] f32, fps)."""
    paths = enumerate_clips(data_dir) if data_dir else []
    if paths:
        from vstab_torch.io.video import read_video

        for p in paths:
            frames, fps = read_video(p, max_frames=max_frames)
            yield os.path.basename(p), frames, fps
    else:
        t, h, w = synth_shape
        if max_frames is not None:
            t = min(t, max_frames)
        for name, frames in synthetic_clip_set(n_synthetic, t=t, h=h, w=w):
            yield name, frames, 30.0


def evaluate_clip(frames: np.ndarray, params, cfg, device=None) -> Tuple[dict, np.ndarray]:
    """Stabilize one clip and compute its metrics: (record, output frames)."""
    from vstab_torch.eval.metrics import evaluate_videos
    from vstab_torch.pipeline import stabilize

    t0 = time.perf_counter()
    out, _ = stabilize(frames, params, cfg, device=device)
    out = out.cpu().numpy()  # waits for the device
    wall = time.perf_counter() - t0
    rec = evaluate_videos(frames, out)
    rec["frames"] = int(frames.shape[0])
    rec["fps"] = round(frames.shape[0] / wall, 3)
    rec["wall_s"] = round(wall, 3)
    return rec, out


def _save_video(save_videos_dir: Optional[str], name: str, out: np.ndarray, fps: float) -> None:
    if save_videos_dir:
        from vstab_torch.io.video import write_video

        os.makedirs(save_videos_dir, exist_ok=True)
        write_video(os.path.join(save_videos_dir, f"{name}.stab.mp4"), out, fps)


def run_sweep(
    data_dir: Optional[str],
    results_path: str,
    cfg=None,
    params=None,
    n_synthetic: int = 8,
    max_frames: Optional[int] = None,
    synth_shape: Tuple[int, int, int] = (48, 256, 320),
    data_parallel: bool = False,
    save_videos_dir: Optional[str] = None,
    device=None,
) -> List[dict]:
    """Per-clip metric sweep with incremental JSONL resume: clips already in
    `results_path` are skipped, and each finished clip is appended at once, so
    a killed sweep resumes at clip granularity. Runs on CUDA unless `device`
    says otherwise. `data_parallel=True` spreads the clips over the ranks of
    the process group when one is up (`_run_dp_batches`); every rank then
    calls this with the same arguments and gets the same records back."""
    from vstab_torch.core.config import Config
    from vstab_torch.pipeline import default_params, resolve_device

    dev = resolve_device(device)
    cfg = cfg if cfg is not None else Config()
    params = params if params is not None else default_params(cfg, device=dev)
    group = dist.group.WORLD if data_parallel and dist.is_initialized() else None
    done = _load_done(results_path) if group is None or dist.get_rank(group) == 0 else None
    if group is not None:  # rank 0's reading of the manifest, on every rank
        box = [done]
        dist.broadcast_object_list(box, src=0, group=group)
        done = box[0]
    results = list(done.values())

    clips = list(_iter_clips(data_dir, n_synthetic, max_frames, synth_shape))
    todo = [(n, f, fps) for n, f, fps in clips if n not in done]

    os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
    if data_parallel and todo:
        results.extend(_run_dp_batches(todo, params, cfg, results_path, save_videos_dir, dev, group))
        return results

    for name, frames, fps in todo:
        rec, out = evaluate_clip(frames, params, cfg, device=dev)
        rec = {"clip": name, **rec}
        _append_record(results_path, rec)
        _save_video(save_videos_dir, name, out, fps)
        results.append(rec)
    return results


def _run_dp_batches(
    todo, params, cfg, results_path: str, save_videos_dir: Optional[str], device, group=None
) -> List[dict]:
    """Clip-level data parallelism: same-shape clips in groups of k, the
    size of `group` (1 with no group). Rank r stabilizes clip r of a group
    through `stabilize_batch` on its own device (one render bucket, picked
    on the host, so strong-shake clips render as in the serial sweep) and
    scores it; the group's records gather on every rank, and rank 0 appends
    them to the manifest in clip order before the next group starts, so a
    killed sweep resumes at clip granularity. In a ragged tail group a rank
    without a clip waits for the others: the reference pads its sharded
    batch with copies of the last clip and drops them, but a rank here is a
    process of its own and has nothing to pad. Each record carries the
    group's size (`batch`), the slowest rank's wall time (`batch_wall_s`)
    and the clip's share of it (`wall_s`, `fps`). Returns the records on
    every rank."""
    from vstab_torch.eval.metrics import evaluate_videos
    from vstab_torch.pipeline import stabilize_batch

    k, rank = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    by_shape: Dict[tuple, list] = {}
    for item in todo:
        by_shape.setdefault(item[1].shape, []).append(item)

    results = []
    for items in by_shape.values():
        for i in range(0, len(items), k):
            group_items = items[i : i + k]
            mine = None
            if rank < len(group_items):
                name, frames, fps = group_items[rank]
                t0 = time.perf_counter()
                out = stabilize_batch(frames[None], params, cfg, device=device)[0].cpu().numpy()
                wall = time.perf_counter() - t0
                mine = ({"clip": name, **evaluate_videos(frames, out)}, wall)
                _save_video(save_videos_dir, name, out, fps)
            gathered = [mine]
            if group is not None:
                gathered = [None] * k
                dist.all_gather_object(gathered, mine, group=group)
            b = len(group_items)
            wall = max(w for _, w in gathered[:b])
            for (_, frames, _), (rec, _) in zip(group_items, gathered):
                # Amortized per-clip accounting, so that batched and serial
                # tables compare: the clip's share of the group's wall time
                # is wall / b; the slowest rank's time is kept as batch_wall_s.
                rec["frames"] = int(frames.shape[0])
                rec["batch"] = b
                rec["fps"] = round(frames.shape[0] / (wall / b), 3)
                rec["wall_s"] = round(wall / b, 3)
                rec["batch_wall_s"] = round(wall, 3)
                if rank == 0:
                    _append_record(results_path, rec)
                results.append(rec)
    return results


def aggregate(results: Sequence[dict]) -> dict:
    """Mean metric triple + throughput over a sweep's records."""
    if not results:
        return {}
    keys = ("stability", "cropping", "distortion", "fps")
    return {k: round(float(np.mean([r[k] for r in results if k in r])), 4) for k in keys}


def report_table(results: Sequence[dict]) -> str:
    """Report table in the format of the repository's BASELINE.md."""
    lines = [
        "| Clip | Stability | Cropping | Distortion | frames/s |",
        "|---|---|---|---|---|",
    ]
    for r in sorted(results, key=lambda r: r["clip"]):
        lines.append(
            f"| {r['clip']} | {r['stability']:.3f} | {r['cropping']:.3f} "
            f"| {r['distortion']:.3f} | {r.get('fps', float('nan')):.1f} |"
        )
    agg = aggregate(results)
    if agg:
        lines.append(
            f"| **mean** | **{agg['stability']:.3f}** | **{agg['cropping']:.3f}**"
            f" | **{agg['distortion']:.3f}** | **{agg['fps']:.1f}** |"
        )
    return "\n".join(lines)


__all__ = [
    "aggregate",
    "enumerate_clips",
    "evaluate_clip",
    "report_table",
    "run_sweep",
    "synthetic_clip",
    "synthetic_clip_set",
]
