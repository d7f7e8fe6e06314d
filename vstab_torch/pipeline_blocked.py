"""Temporal-block streaming pipeline on one card, the port of
`vstab/pipeline_blocked.py`.

Device memory is bounded at O(block), so clips far longer than device memory
fit one card. The pixel stages (flow, render) are block-local and streamed;
the path stages work on the per-frame motion summary ([GH,GW,2] for sparse-LS
or [2,3] for affine, a few hundred bytes a frame), so the smoothing solve runs
globally and exactly and block boundaries leave no seam: blocked = whole clip
(`tests/test_torch_blocked.py`).

Sweeps (each streams blocks of `block_len` frames through the card):
  1. motion:  flow on [B+1]-frame blocks (1-frame overlap = the pair halo)
              -> vertex motion / pair affines, accumulated on the host;
  -. solve:   global smoothing solve on the tiny path arrays (device);
  2. scale:   the clip's crop zoom; 'auto': min of the per-frame bounds;
  3. render:  warp + crop each block with the global scale, stream out.

How the host and the card overlap:
  * frames cross the bus as they come (uint8 from a file: a quarter of f32's
    bytes); the stages normalize on the device, and the render quantizes back
    to uint8 on the device before the fetch;
  * uploads go from two alternating pinned staging buffers with
    `non_blocking=True`; a buffer is refilled only after the event recorded
    behind its last upload has completed (`_Staging`);
  * both pixel sweeps keep a 1-deep dispatch pipeline: block i's result is
    fetched while the card works on block i+1. `tensor.cpu()` would wait for
    everything queued on the stream, block i+1 included, so a result is
    fetched on a second stream that waits for an event recorded behind
    block i's last kernel, into pinned memory, and the host waits for that
    copy's event only (`_Fetch`);
  * a bounded prefetch thread decodes the next block meanwhile (`_prefetch`);
  * every block is padded to one shape, so a run gives the kernels and cuDNN
    one set of shapes; every sweep logs per-block progress.

Where the host's time goes: the call's stats give `stage_s` (the sweeps, from
the spans `vstab.blocked.motion_sweep`, `.solve` + `.scale_sweep` and
`.render_sweep`), `host_s` (the self seconds of the per-block host spans:
waiting for the prefetch thread, for a staging buffer or for a fetch;
copying into a staging buffer or out of a fetch; dispatching a block;
allocating pinned memory; waiting for the output's pages) and `pinned_bytes`
(the pinned host memory the call asked for). They are timed whether or not
`vstab_torch.utils.trace` records.

A fresh host output is mapped but not resident: the first write to each page
faults. `stabilize_blocked` faults its output in on a few threads while the
motion sweep runs (`_Prefault`), render slice by render slice, so the render
sweep's drain copies into resident memory; the stats' `prefault_bytes` is the
output's size then, 0 where the writer owns no array.

Fault tolerance: `stabilize_video_blocked` keeps a `<out>.resume/` directory
with per-block motion results (the expensive sweep) and the solved scale; a
killed run resumes at block granularity, cached motion blocks are loaded, not
recomputed. The directory is removed on success.

`stabilize_blocked` takes in-memory host frames; `stabilize_video_blocked`
streams from a video file to a video file through `io/video.py` in constant
host memory. Both run on the CUDA device unless given `device="cpu"`.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import queue
import shutil
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from vstab_torch.core.config import Config
from vstab_torch.core.precision import pin_full_f32
from vstab_torch.pipeline import (
    Params,
    clip_flow,
    params_on,
    path_to_flow,
    render_bucket,
    resolve_device,
)
from vstab_torch.render.render import auto_crop_scales, fixed_crop_scale, render_stabilized
from vstab_torch.smooth.stages import pair_motion, solve_path
from vstab_torch.utils import trace

log = logging.getLogger("vstab_torch.blocked")


# ---------------------------------------------------------------------------
# Per-block stages (blocks are padded to block_len: one set of shapes a run)
# ---------------------------------------------------------------------------


def _norm(frames: torch.Tensor) -> torch.Tensor:
    """Device-side normalization: uint8 RGB -> f32 [0,1]; f32 passes through
    (the in-memory API feeds float frames directly)."""
    if frames.dtype == torch.uint8:
        return frames.float() * (1.0 / 255.0)
    return frames.float()


@torch.inference_mode()
def _block_motion(params: Params, blk: torch.Tensor, cfg: Config) -> torch.Tensor:
    """[B+1,H,W,3] frames (uint8 or f32) -> `pair_motion` of its B pairs."""
    return pair_motion(clip_flow(params, _norm(blk), cfg), cfg.smooth)


@torch.inference_mode()
def _block_render(
    frames: torch.Tensor, path_blk: torch.Tensor, scale, cfg: Config,
    max_disp: Optional[int] = None, to_uint8: bool = False,
) -> torch.Tensor:
    wf = path_to_flow(path_blk, cfg, tuple(frames.shape[1:3]))
    out = render_stabilized(_norm(frames), wf, cfg.render, scale=scale, max_disp=max_disp)
    if to_uint8:  # quantize on the device: the fetch is a quarter the size
        return torch.clamp(out * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return out


def _rss_gb() -> float:
    """Current process RSS in GB (VmRSS), for the per-block log lines."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def _pad_block(x: torch.Tensor, n: int) -> torch.Tensor:
    """Pad axis 0 to length n by repeating the last entry (freeze-frame)."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x[-1:].expand(n - x.shape[0], *x.shape[1:])], dim=0)


# ---------------------------------------------------------------------------
# Host <-> device traffic
# ---------------------------------------------------------------------------


_HOST_SPANS = ("prefetch_wait", "staging_wait", "stage_copy", "dispatch", "pinned_alloc",
               "fetch_wait", "drain_copy", "out_wait")


class _Host:
    """The host's side of one blocked call: `s`, the self seconds of each
    per-block span `vstab.blocked.<key>` (keys `_HOST_SPANS`), and the bytes
    of pinned host memory asked for."""

    def __init__(self):
        self.s: Dict[str, float] = dict.fromkeys(_HOST_SPANS, 0.0)
        self.pinned_bytes = 0

    def span(self, key: str):
        return trace.span("vstab.blocked." + key, into=self.s)

    def empty(self, shape, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
        if not pinned:
            return torch.empty(shape, dtype=dtype)
        with self.span("pinned_alloc"):
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.pinned_bytes += buf.numel() * buf.element_size()
        return buf


class _Staging:
    """Two alternating host staging buffers of one sweep's uploads. For a
    CUDA device they are pinned and the upload is asynchronous; buffer i%2 is
    handed out for refilling only after the event recorded behind its last
    upload has completed. For the CPU the buffer itself is the block (the
    stages run synchronously and write into new tensors)."""

    def __init__(self, shape, np_dtype, device: torch.device, host: _Host):
        self.device, self.host = device, host
        dtype = torch.from_numpy(np.empty(0, np_dtype)).dtype
        self._bufs = [host.empty(shape, dtype, device.type == "cuda") for _ in range(2)]
        self._uploaded = [None, None]

    def buffer(self, i: int) -> np.ndarray:
        """The numpy view of buffer i%2, free to be overwritten."""
        ev = self._uploaded[i % 2]
        if ev is not None:
            with self.host.span("staging_wait"):
                ev.synchronize()
        return self._bufs[i % 2].numpy()

    def upload(self, i: int) -> torch.Tensor:
        buf = self._bufs[i % 2]
        if self.device.type != "cuda":
            return buf
        out = buf.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._uploaded[i % 2] = ev
        return out


class _Fetch:
    """Device -> host fetch of one result that waits for that result only.

    The copy runs on `copy_stream` behind an event recorded on the current
    stream just after the result's last kernel, into pinned memory;
    `result()` waits for the copy's own event, not for work queued since.
    The device tensor is kept until then, so the caching allocator cannot
    hand its memory to a later block while the copy is still to run.

    Against a plain `.cpu()` at the drain, warm blocked runs process 2.5 to 3
    times the frames a second at 95x720x1280 and about 2 times at
    33x1080x1920 (`chip_smoke.py`'s fetch A/B, NVIDIA H100 80GB HBM3,
    700.00 W)."""

    def __init__(self, x: torch.Tensor, copy_stream, host: _Host):
        self._ready, self._spans = None, host
        if not x.is_cuda:
            self._host = x
            return
        done = torch.cuda.Event()
        done.record()
        self._keep = x
        self._host = host.empty(x.shape, x.dtype, True)
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(done)
            self._host.copy_(x, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()

    def result(self) -> np.ndarray:
        if self._ready is not None:
            with self._spans.span("fetch_wait"):
                self._ready.synchronize()
            self._keep = None
        return self._host.numpy()


# ---------------------------------------------------------------------------
# Decode prefetcher: overlap host video decode with device compute
# ---------------------------------------------------------------------------


def _prefetch(gen: Iterator, depth: int = 2, into: Optional[Dict[str, float]] = None) -> Iterator:
    """Run `gen` in a daemon thread with a bounded queue. The producer
    decodes block i+1/i+2 while the consumer's device work on block i is in
    flight; the consumer's waits are the span `vstab.blocked.prefetch_wait`
    (its seconds added to `into`). Exceptions propagate; early consumer exit
    unblocks the producer via the stop flag."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    err: list = []

    def run():
        try:
            for item in gen:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    th = threading.Thread(target=run, daemon=True, name="vstab-decode")
    th.start()
    try:
        while True:
            with trace.span("vstab.blocked.prefetch_wait", into=into):
                item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


# ---------------------------------------------------------------------------
# Block-level resume state
# ---------------------------------------------------------------------------


def _params_digest(params: Params) -> str:
    """sha256 over the flow net's state dict (sorted names, shapes, dtypes,
    bytes). Cached motion blocks were computed by a specific network;
    resuming with other weights must invalidate them. One pass over the
    weights (one fetch if they are on the device) a run."""
    h = hashlib.sha256()
    for name in sorted(params):
        arr = params[name].detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(tuple(arr.shape)).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _input_identity(path: Optional[str]) -> dict:
    """Identity of the input video: abspath + size + mtime_ns. A resumed run
    pointed at a different same-length input must not reuse cached motion."""
    if path is None:
        return {}
    try:
        st = os.stat(path)
        return {
            "input": os.path.abspath(path),
            "input_size": int(st.st_size),
            "input_mtime_ns": int(st.st_mtime_ns),
        }
    except OSError:
        return {"input": os.path.abspath(path)}


class _ResumeState:
    """Per-block motion cache + solved-scale cache in `<out>.resume/`.

    Each motion block is one `motion_<start>.npy`, written atomically
    (tmp + rename) so a kill mid-write never leaves a torn block. meta.json
    pins (cfg, t, block_len, input identity, frame shape, params digest);
    any mismatch wipes the directory: stale state from a different run,
    input file or checkpoint must never leak in."""

    def __init__(
        self, root: str, cfg: Config, t: int, b: int,
        in_path: Optional[str] = None, hw: Optional[Tuple[int, int]] = None,
        params: Optional[Params] = None,
    ):
        self.root = root
        meta = {
            "cfg_sha": hashlib.sha256(cfg.to_json().encode()).hexdigest(),
            "t": int(t),
            "b": int(b),
            **_input_identity(in_path),
        }
        if hw is not None:
            meta["hw"] = [int(hw[0]), int(hw[1])]
        if params is not None:
            meta["params_sha"] = _params_digest(params)
        mpath = os.path.join(root, "meta.json")
        if os.path.isdir(root):
            try:
                with open(mpath) as f:
                    old = json.load(f)
            except (OSError, json.JSONDecodeError):
                old = None
            if old != meta:
                log.warning("resume dir %s stale (config/shape changed); wiping", root)
                shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root, exist_ok=True)
        if not os.path.exists(mpath):
            with open(mpath + ".tmp", "w") as f:
                json.dump(meta, f)
            os.replace(mpath + ".tmp", mpath)

    def _mpath(self, start: int) -> str:
        return os.path.join(self.root, f"motion_{start:08d}.npy")

    def load_motion(self, start: int) -> Optional[np.ndarray]:
        p = self._mpath(start)
        if not os.path.exists(p):
            return None
        try:
            return np.load(p)
        except (OSError, ValueError):  # torn/corrupt block: recompute
            return None

    def save_motion(self, start: int, m: np.ndarray) -> None:
        p = self._mpath(start)
        np.save(p + ".tmp.npy", m)
        os.replace(p + ".tmp.npy", p)

    def load_scale(self) -> Optional[float]:
        try:
            with open(os.path.join(self.root, "scale.json")) as f:
                return float(json.load(f)["scale"])
        except (OSError, json.JSONDecodeError, KeyError, ValueError):
            return None

    def save_scale(self, scale: float) -> None:
        p = os.path.join(self.root, "scale.json")
        with open(p + ".tmp", "w") as f:
            json.dump({"scale": float(scale)}, f)
        os.replace(p + ".tmp", p)

    def finalize(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


# ---------------------------------------------------------------------------
# In-memory entry point
# ---------------------------------------------------------------------------


def stabilize_blocked(
    frames, params: Params, cfg: Config = Config(), block_len: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Stabilize [T,H,W,3] host frames (f32 in [0,1] or uint8) with O(block)
    device memory -> f32 [T,H,W,3] on the host.

    Equivalent to `vstab_torch.pipeline.stabilize` (same flow per pair, same
    global solve, same crop scale, same adaptive displacement bound)."""
    dev = resolve_device(device)
    frames = np.asarray(frames)
    t = frames.shape[0]
    b = int(block_len or cfg.dist.time_block_len)

    def chunks() -> Iterator[Tuple[np.ndarray, int]]:
        for i in range(0, t, b):
            yield frames[i : i + b], i

    out = np.empty(frames.shape, dtype=np.float32)

    def writer(blk: np.ndarray, start: int) -> None:
        out[start : start + blk.shape[0]] = blk

    with _Prefault(out, b) as prefault:
        _run_blocked(chunks, writer, t, params_on(params, dev), cfg, b, dev, prefault=prefault)
    return out


# ---------------------------------------------------------------------------
# File-to-file streaming entry point (constant host memory)
# ---------------------------------------------------------------------------


def stabilize_video_blocked(
    in_path: str,
    out_path: str,
    params: Params,
    cfg: Config = Config(),
    block_len: Optional[int] = None,
    max_frames: Optional[int] = None,
    resume: bool = True,
    device=None,
) -> dict:
    """Stream-stabilize a video file: decode -> blocks -> encode, never
    holding more than a few blocks of uint8 pixels on host or device.
    `resume=True` keeps `<out>.resume/` so a killed run restarts at block
    granularity instead of frame 0 (removed on success)."""
    from vstab_torch.io.video import probe_video, read_video_chunks, write_video_frames

    dev = resolve_device(device)
    b = int(block_len or cfg.dist.time_block_len)
    t, fps, hw = probe_video(in_path)
    if max_frames is not None:
        t = min(t, max_frames) if t > 0 else max_frames

    def chunks() -> Iterator[Tuple[np.ndarray, int]]:
        seen = 0
        for blk, start in read_video_chunks(in_path, chunk_frames=b, dtype="uint8"):
            if max_frames is not None and seen + blk.shape[0] > max_frames:
                blk = blk[: max_frames - seen]
                if blk.shape[0] == 0:
                    return
            seen += blk.shape[0]
            yield blk, start

    if t <= 0:  # the container did not report a frame count: decode once
        t = sum(blk.shape[0] for blk, _ in chunks())

    params = params_on(params, dev)
    resume_state = (
        _ResumeState(out_path + ".resume", cfg, t, b, in_path=in_path, hw=hw, params=params)
        if resume
        else None
    )
    with write_video_frames(out_path, fps=fps, codec=cfg.io.output_codec) as w:
        stats = _run_blocked(
            chunks, lambda blk, start: w.write(blk), t, params, cfg, b, dev,
            resume_state=resume_state, out_dtype="uint8",
        )
    if resume_state is not None:
        resume_state.finalize()
    stats.update({"input": in_path, "output": out_path, "fps": fps})
    return stats


# Resolution-adaptive render block (pixels x frames per render dispatch): the
# two-pass warp holds several full-size f32 buffers live (normalized frames,
# the wrap-padded shifted copy, per-pass fields and outputs, the zoom's
# intermediate). The budget keeps 720p and 1080p dispatches at the full block
# length of 64 and re-chunks 4K to 16 frames. One 64-frame 1080p uint8
# dispatch at d=127 peaks at 12.0 GB of device memory
# (`torch.cuda.max_memory_allocated()` in `chip_smoke.py`, NVIDIA H100 80GB
# HBM3, 700.00 W), so 4K at 16 frames stays near that.
_RENDER_PX_FRAMES_BUDGET = 64 * 2_100_000


def _render_block_len(b: int, hw: Tuple[int, int]) -> int:
    """Frames a render dispatch: `b`, cut to `_RENDER_PX_FRAMES_BUDGET`."""
    return min(b, max(1, _RENDER_PX_FRAMES_BUDGET // (hw[0] * hw[1])))


def _render_slices(t: int, b: int, rb: int) -> list:
    """The frame ranges [start, stop) the render sweep dispatches and drains,
    in order: each `b`-frame block cut into `rb`-frame dispatches."""
    return [(j, min(j + rb, i + b, t)) for i in range(0, t, b) for j in range(i, min(i + b, t), rb)]


# Threads that fault in a fresh output: a few, and one core fewer than the
# host has, so the thread that dispatches to the card keeps one to itself.
_PREFAULT_THREADS = max(1, min(4, (os.cpu_count() or 1) - 1))


class _Prefault:
    """Faults in the pages of a fresh host output `out` [T,...] on
    `_PREFAULT_THREADS` threads, ahead of the render sweep's drain.

    `np.empty` of a clip's output (6.4 GB at 256 frames of 1080p f32) maps
    pages that the first write faults in; without this, the writer's copy of
    each fetched block paid those faults while the card waited for the next
    block: a pinned 64-frame 1080p f32 block copies in 0.62 to 0.64 s into a
    fresh array and 0.17 to 0.18 s into a touched one, and this helper faults
    in the whole 6.4 GB in 1.03 to 1.17 s on 4 threads, inside the motion
    sweep's ~2.8 s (`perf_records/prefault_ab.py` on the host of an NVIDIA
    H100 80GB HBM3, 8 cores). Here each render slice (`_render_slices`, in drain order, each
    split across the threads) gets one element written 0 in every OS page it
    spans, its first and its last; `wait(start)` returns once the slice
    starting at frame `start` is resident. The drain's copy then overwrites
    every element. A strided numpy write releases the GIL, so the motion
    sweep's dispatching thread runs on meanwhile.

    A context manager: the threads start on entry; on exit they are stopped,
    joined, and the first exception one of them raised is raised."""

    def __init__(self, out: np.ndarray, b: int):
        self.nbytes = out.nbytes
        self.slices = _render_slices(out.shape[0], b, _render_block_len(b, out.shape[1:3]))
        self._flat = out.reshape(-1)  # a view: `out` is a fresh C-contiguous array
        self._addr, self._page = self._flat.ctypes.data, os.sysconf("SC_PAGE_SIZE")
        frame = self._flat.size // max(out.shape[0], 1)
        n = _PREFAULT_THREADS
        parts = []  # (slice start, first element, end element), slices in drain order
        for start, stop in self.slices:
            lo, hi = start * frame, stop * frame
            cuts = [lo + (hi - lo) * k // n for k in range(n + 1)]
            parts += [(start, a, z) for a, z in zip(cuts, cuts[1:]) if z > a]
        self._left = collections.Counter(start for start, _, _ in parts)
        self._todo = iter(parts)
        self._ready = {start: threading.Event() for start, _ in self.slices}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._err: list = []
        self._threads = [threading.Thread(target=self._run, daemon=True, name=f"vstab-prefault-{i}")
                         for i in range(n)]

    def __enter__(self) -> "_Prefault":
        for th in self._threads:
            th.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._stop.set()
        for th in self._threads:
            th.join()
        if self._err and exc_type is None:
            raise self._err[0]

    def wait(self, start: int) -> None:
        """Block until the slice that starts at frame `start` is resident."""
        self._ready[start].wait()
        if self._err:
            raise self._err[0]

    def _touch(self, lo: int, hi: int) -> None:
        """Write 0 to the elements [lo, hi) that start an OS page, and to the first and the last."""
        flat, size = self._flat, self._flat.itemsize
        to_page = -(self._addr + lo * size) % self._page  # bytes from element lo to a page's start
        flat[lo + to_page // size : hi : self._page // size] = 0
        flat[lo] = flat[hi - 1] = 0

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                with self._lock:
                    part = next(self._todo, None)
                if part is None:
                    return
                start, lo, hi = part
                self._touch(lo, hi)
                with self._lock:
                    self._left[start] -= 1
                    done = self._left[start] == 0
                if done:
                    self._ready[start].set()
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            self._err.append(e)
            self._stop.set()
            for ev in self._ready.values():
                ev.set()


# ---------------------------------------------------------------------------
# The three sweeps
# ---------------------------------------------------------------------------


@torch.inference_mode()
def _run_blocked(
    make_chunks, writer, t: int, params: Params, cfg: Config, b: int,
    dev: torch.device, resume_state: Optional[_ResumeState] = None,
    out_dtype: str = "float32", prefault: Optional[_Prefault] = None,
) -> dict:
    """Drive the sweeps. `make_chunks()` returns a fresh iterator of
    ([<=b,H,W,3] uint8-or-f32, start) host blocks covering frames [0, t);
    `params` are on `dev`. With `prefault`, the render sweep writes a slice
    only once `prefault` has made it resident."""
    pin_full_f32()
    sweep_s: Dict[str, float] = {}
    host = _Host()
    with trace.span("vstab.blocked", into=sweep_s, t=t, block_len=b):
        n_blocks = -(-t // b)
        copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        with trace.span("vstab.blocked.motion_sweep", into=sweep_s):
            motion, hw, cached_blocks = _motion_sweep(
                make_chunks, t, params, cfg, b, dev, resume_state, copy_stream, host, n_blocks)

        # --- global path solve (tiny) + adaptive render displacement bound.
        # The path goes to the device once; the sweeps below slice it there.
        with trace.span("vstab.blocked.solve", into=sweep_s):
            path = solve_path(torch.from_numpy(np.ascontiguousarray(motion)).to(dev),
                              cfg.smooth)[0].cpu().numpy()  # [T, GH,GW,2] or [T,2,3]
            _, max_disp = render_bucket(path, cfg, hw)
            path_dev = torch.from_numpy(path).to(dev)
        log.info("path solved: T=%d, render max_disp=%d", t, max_disp)

        # --- sweep 2: the clip's crop zoom, made once; 'auto' streams the
        # dense flow in path-blocks (elementwise; no pixels touched).
        with trace.span("vstab.blocked.scale_sweep", into=sweep_s):
            scale = fixed_crop_scale(cfg.render, dev)
            starts = range(0, t, b)
            per_block = auto_crop_scales(
                (path_to_flow(_pad_block(path_dev[i : i + b], b), cfg, hw) for i in starts), cfg.render)
            if per_block is not None:
                smin = resume_state.load_scale() if resume_state is not None else None
                if smin is None:
                    smin = min([1.0] + [float(s[: t - i].min()) for i, s in zip(starts, per_block)])
                    if resume_state is not None:
                        resume_state.save_scale(smin)
                scale = torch.tensor(smin, dtype=torch.float32, device=dev)

        with trace.span("vstab.blocked.render_sweep", into=sweep_s):
            _render_sweep(make_chunks, writer, t, path_dev, scale, max_disp, cfg, b, dev,
                          out_dtype, copy_stream, host, hw, prefault)

    wall = sum(sweep_s.values())
    stats = {
        "frames": t,
        "block_len": b,
        "max_disp": int(max_disp),
        "wall_s": round(wall, 3),
        "stage_s": {
            "flow": round(sweep_s["motion_sweep"], 3),
            "scale": round(sweep_s["solve"] + sweep_s["scale_sweep"], 3),
            "render": round(sweep_s["render_sweep"], 3),
        },
        "host_s": {k: round(v, 6) for k, v in host.s.items()},
        "pinned_bytes": host.pinned_bytes,
        "prefault_bytes": prefault.nbytes if prefault is not None else 0,
        "fps_processed": round(t / max(wall, 1e-9), 2),
        "resume_cached_blocks": cached_blocks,
    }
    log.info("blocked stabilize: %s", stats)
    return stats


def _block_log(what: str, bi: int, n_blocks: int, start: int, n: int, tb: float) -> None:
    """One block's progress line, made only when INFO is on (it reads RSS).
    The message starts with `what`: `chip_smoke.py` reads the RSS by it."""
    if log.isEnabledFor(logging.INFO):
        log.info(
            what + " block %d/%d (frames %d..%d) %.1f fps rss %.1fGB",
            bi + 1, n_blocks, start, start + n - 1,
            n / max(time.perf_counter() - tb, 1e-9), _rss_gb(),
        )


def _motion_sweep(
    make_chunks, t: int, params: Params, cfg: Config, b: int, dev: torch.device,
    resume_state: Optional[_ResumeState], copy_stream, host: _Host, n_blocks: int,
) -> Tuple[np.ndarray, Tuple[int, int], int]:
    """Sweep 1, per-pair motion -> (motion [T-1,...], (H, W), blocks loaded
    from the resume cache). Blocks get a 1-frame left halo (the previous
    block's last frame) so every consecutive pair is covered; the first
    block's halo is a duplicate of frame 0 whose pair (a frame with itself)
    is discarded. Uniform [b+1] shape. 1-deep dispatch pipeline: block i's
    motion is fetched and saved while the card works on i+1."""
    motions = []
    prev_last: Optional[np.ndarray] = None
    staging: Optional[_Staging] = None
    hw: Optional[Tuple[int, int]] = None
    cached_blocks = 0
    pending = None  # (fetch, n, start, bi, tb)

    def drain(p):
        fetch, n, start, bi, tb = p
        res = fetch.result()
        with host.span("drain_copy"):
            m = np.array(res[:n])
        if start == 0:
            m = m[1:]  # drop the duplicate (f0, f0) pair
        if resume_state is not None:
            resume_state.save_motion(start, m)
        motions.append(m)
        _block_log("motion", bi, n_blocks, start, n, tb)

    for bi, (blk, start) in enumerate(_prefetch(make_chunks(), into=host.s)):
        tb = time.perf_counter()
        n = blk.shape[0]
        if staging is None:
            hw = (blk.shape[1], blk.shape[2])
            staging = _Staging((b + 1,) + blk.shape[1:], blk.dtype, dev, host)
        cached = resume_state.load_motion(start) if resume_state is not None else None
        if cached is not None:
            if pending is not None:
                drain(pending)
                pending = None
            motions.append(cached)
            cached_blocks += 1
            prev_last = np.copy(blk[-1])
            continue
        ext_buf = staging.buffer(bi)
        with host.span("stage_copy"):
            ext_buf[0] = blk[0] if prev_last is None else prev_last
            ext_buf[1 : 1 + n] = blk
            if n < b:  # freeze-frame pad (zero pair motion, trimmed in the drain)
                ext_buf[1 + n :] = blk[-1]
            prev_last = np.copy(blk[-1])
        with host.span("dispatch"):
            fetch = _Fetch(_block_motion(params, staging.upload(bi), cfg), copy_stream, host)
        if pending is not None:
            drain(pending)
        pending = (fetch, n, start, bi, tb)
    if pending is not None:
        drain(pending)
    motion = np.concatenate(motions, axis=0)
    if motion.shape[0] != t - 1:
        raise RuntimeError(f"motion sweep covered {motion.shape[0]} pairs of a {t}-frame clip")
    if cached_blocks:
        log.info("motion sweep: %d/%d blocks loaded from resume cache",
                 cached_blocks, n_blocks)
    return motion, hw, cached_blocks


def _render_sweep(
    make_chunks, writer, t: int, path_dev: torch.Tensor, scale, max_disp: int, cfg: Config,
    b: int, dev: torch.device, out_dtype: str, copy_stream, host: _Host, hw: Tuple[int, int],
    prefault: Optional[_Prefault],
) -> None:
    """Sweep 3, render + stream out. 1-deep dispatch pipeline: fetch and
    write block i while the card renders block i+1."""
    to_u8 = out_dtype == "uint8"
    rb = _render_block_len(b, hw)
    n_rblocks = -(-t // rb)

    def rechunk(gen: Iterator) -> Iterator:
        for blk, start in gen:
            for j in range(0, blk.shape[0], rb):
                yield blk[j : j + rb], start + j

    def drain(p):
        fetch, start = p
        res = fetch.result()
        if prefault is not None:
            with host.span("out_wait"):
                prefault.wait(start)
        with host.span("drain_copy"):
            writer(res, start)

    staging = None
    pending = None  # (fetch, start)
    for bi, (blk, start) in enumerate(_prefetch(rechunk(make_chunks()), into=host.s)):
        tb = time.perf_counter()
        n = blk.shape[0]
        if staging is None:
            staging = _Staging((rb,) + blk.shape[1:], blk.dtype, dev, host)
        frame_buf = staging.buffer(bi)
        with host.span("stage_copy"):
            frame_buf[:n] = blk
            if n < rb:
                frame_buf[n:] = blk[-1]
        with host.span("dispatch"):
            out_dev = _block_render(
                staging.upload(bi), _pad_block(path_dev[start : start + n], rb), scale, cfg,
                max_disp=max_disp, to_uint8=to_u8,
            )
            fetch = _Fetch(out_dev[:n], copy_stream, host)
            del out_dev
        if pending is not None:
            drain(pending)
        pending = (fetch, start)
        _block_log("render", bi, n_rblocks, start, n, tb)
    if pending is not None:
        drain(pending)


__all__ = ["stabilize_blocked", "stabilize_video_blocked"]
