"""Host-side video I/O, the port's copy of `vstab/io/video.py`: OpenCV decode
and encode, frames as numpy THWC RGB, float32 in [0,1] or raw uint8.

`cv2` is imported inside the functions, so importing the package (or the
blocked pipeline, which reaches this module only for file-to-file runs) does
not need OpenCV.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def _open(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    return cap


def read_video(
    path: str, max_frames: Optional[int] = None, stride: int = 1
) -> Tuple[np.ndarray, float]:
    """Decode a video file -> (frames [T,H,W,3] float32 RGB in [0,1], fps)."""
    import cv2

    cap = _open(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frames = []
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if i % stride == 0:
                frames.append(
                    cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
                )
            i += 1
            if max_frames is not None and len(frames) >= max_frames:
                break
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames), float(fps)


def read_video_chunks(
    path: str, chunk_frames: int, halo: int = 0, dtype: str = "float32"
) -> Iterator[Tuple[np.ndarray, int]]:
    """Stream a video in overlapping temporal chunks (for long-clip blocking).

    Yields (frames [<=chunk+2*halo, H, W, 3], start_index). Neighboring chunks
    overlap by `halo` frames on each side. dtype 'uint8' yields raw RGB bytes
    (a quarter of float32's host memory and bus traffic; the blocked pipeline
    normalizes on the device).
    """
    import cv2

    cap = _open(path)
    try:
        as_u8 = dtype == "uint8"
        buf = []
        start = 0
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            buf.append(rgb if as_u8 else rgb.astype(np.float32) / 255.0)
            idx += 1
            if len(buf) == chunk_frames + 2 * halo:
                yield np.stack(buf), start
                keep = 2 * halo
                start = idx - keep
                buf = buf[-keep:] if keep else []
        if buf:
            yield np.stack(buf), start
    finally:
        cap.release()


def probe_video(path: str) -> Tuple[int, float, Tuple[int, int]]:
    """(frame count as the container reports it, 0 if unknown; fps, 30 if
    unknown; (height, width)). Raises FileNotFoundError if it cannot open."""
    import cv2

    cap = _open(path)
    try:
        return (
            int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            cap.get(cv2.CAP_PROP_FPS) or 30.0,
            (int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))),
        )
    finally:
        cap.release()


def write_video(
    path: str, frames: np.ndarray, fps: float = 30.0, codec: str = "mp4v"
) -> None:
    """Encode frames [T,H,W,3] float [0,1] (or uint8) RGB to a video file."""
    with write_video_frames(path, fps=fps, codec=codec) as w:
        w.write(frames)


class write_video_frames:
    """Incremental video encoder for the blocked pipeline: call
    `.write(frames_block)` repeatedly, then `.close()`. The cv2.VideoWriter
    is opened lazily on the first block (frame size known then)."""

    def __init__(self, path: str, fps: float = 30.0, codec: str = "mp4v"):
        self.path = path
        self.fps = float(fps)
        self.codec = codec
        self._w = None

    def write(self, frames: np.ndarray) -> None:
        import cv2

        if frames.dtype != np.uint8:
            frames = (np.clip(frames, 0.0, 1.0) * 255.0).astype(np.uint8)
        if self._w is None:
            h, w = frames.shape[1:3]
            fourcc = cv2.VideoWriter_fourcc(*self.codec)
            self._w = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
            if not self._w.isOpened():
                raise IOError(f"cannot open video writer: {self.path}")
        for f in frames:
            self._w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self._w is not None:
            self._w.release()
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = [
    "probe_video",
    "read_video",
    "read_video_chunks",
    "write_video",
    "write_video_frames",
]
