"""Stabilization quality metrics, the port of `vstab/eval/metrics.py`.

Stability score, cropping ratio and distortion, all derived from per-frame
2D transforms (the Bundled-Camera-Paths protocol). The three scores are
plain functions on tensors. The transforms come either from the pipeline
(exact) or from the two OpenCV trackers below, which run on the host and
work on any pair of videos: `evaluate_videos` uses the trackers.
"""

from __future__ import annotations

import numpy as np
import torch


def stability_score(pair_transforms: torch.Tensor) -> torch.Tensor:
    """Stability of a video given its inter-frame transforms [T-1,2,3].

    Translation x, translation y and rotation angle are accumulated into
    1-D camera paths; for each, stability = (energy of frequencies 2..6) /
    (total energy without DC) of its FFT; the score is the average over the
    three. Higher = more stable. A motionless component (no AC energy) counts
    as perfectly stable; a path with fewer than 6 frequency bins uses the
    bins it has."""
    a = pair_transforms
    tx = torch.cumsum(a[:, 0, 2], 0)
    ty = torch.cumsum(a[:, 1, 2], 0)
    ang = torch.cumsum(torch.atan2(a[:, 1, 0], a[:, 0, 0]), 0)

    def comp(sig: torch.Tensor) -> torch.Tensor:
        spec = torch.abs(torch.fft.rfft(sig)) ** 2
        total = torch.sum(spec[1:])
        low = torch.sum(spec[1:6])  # 2nd..6th components (1-based), DC excluded
        return torch.where(total > 1e-8, low / torch.clamp(total, min=1e-8), torch.ones_like(total))

    return (comp(tx) + comp(ty) + comp(ang)) / 3.0


def cropping_ratio(in_out_transforms: torch.Tensor) -> torch.Tensor:
    """Mean per-frame retained scale of the input->output transforms [T,2,3]:
    the scale of the affine part is sqrt(|det|), clipped at 1 (zooming out
    cannot gain content)."""
    lin = in_out_transforms[:, :, :2]
    det = torch.abs(lin[:, 0, 0] * lin[:, 1, 1] - lin[:, 0, 1] * lin[:, 1, 0])
    scale = torch.sqrt(det + 1e-12)
    return torch.mean(torch.minimum(scale, 1.0 / torch.clamp(scale, min=1e-6)))


def distortion_score(in_out_transforms: torch.Tensor) -> torch.Tensor:
    """Worst-case anisotropy: min over frames of sigma_min / sigma_max of the
    affine part: 1.0 for similarity transforms, lower = more distortion."""
    lin = in_out_transforms[:, :, :2]
    # singular values of a 2x2 matrix from the eigenvalues of A^T A
    ata = torch.einsum("tij,tik->tjk", lin, lin)
    tr = ata[:, 0, 0] + ata[:, 1, 1]
    det = ata[:, 0, 0] * ata[:, 1, 1] - ata[:, 0, 1] * ata[:, 1, 0]
    disc = torch.sqrt(torch.clamp(tr**2 / 4.0 - det, min=0.0))
    s1 = torch.sqrt(torch.clamp(tr / 2.0 + disc, min=1e-12))
    s2 = torch.sqrt(torch.clamp(tr / 2.0 - disc, min=0.0))
    return torch.min(s2 / s1)


def _to_u8(frames: np.ndarray) -> np.ndarray:
    if frames.dtype == np.uint8:
        return frames
    return (np.clip(frames, 0, 1) * 255).astype(np.uint8)


def _track(g0: np.ndarray, g1: np.ndarray):
    """Corners of g0 tracked into g1 (sparse KLT): (p0, p1) of the points that
    were found, or None when there are fewer than 6."""
    import cv2

    p0 = cv2.goodFeaturesToTrack(g0, maxCorners=400, qualityLevel=0.01, minDistance=8)
    if p0 is None or len(p0) < 6:
        return None
    p1, st, _ = cv2.calcOpticalFlowPyrLK(g0, g1, p0, None)
    good = st.reshape(-1) == 1
    if good.sum() < 6:
        return None
    return p0[good], p1[good]


_EYE = np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float64)


def estimate_pair_transforms_cv(frames: np.ndarray) -> np.ndarray:
    """[T,H,W,3] float or uint8 -> [T-1,2,3] inter-frame affines: sparse KLT
    tracking + a robust similarity fit (OpenCV, on the host)."""
    import cv2

    grays = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in _to_u8(frames)]
    out = []
    for t in range(len(grays) - 1):
        pts = _track(grays[t], grays[t + 1])
        m = None
        if pts is not None:
            m, _ = cv2.estimateAffinePartial2D(
                pts[0], pts[1], method=cv2.RANSAC, ransacReprojThreshold=2.0
            )
        out.append(_EYE.copy() if m is None else m)
    return np.stack(out).astype(np.float32)


def estimate_cross_transforms_cv(in_frames: np.ndarray, out_frames: np.ndarray) -> np.ndarray:
    """Per-frame input_t -> output_t affines [T,2,3], for the cropping and
    distortion of any stabilized video. A full 6-parameter fit
    (`cv2.estimateAffine2D`): a similarity fit has equal singular values by
    construction, so `distortion_score` of its output would always be 1."""
    import cv2

    out = []
    for t in range(len(in_frames)):
        g0 = cv2.cvtColor(_to_u8(in_frames[t]), cv2.COLOR_RGB2GRAY)
        g1 = cv2.cvtColor(_to_u8(out_frames[t]), cv2.COLOR_RGB2GRAY)
        pts = _track(g0, g1)
        m = None
        if pts is not None:
            m, _ = cv2.estimateAffine2D(
                pts[0], pts[1], method=cv2.RANSAC, ransacReprojThreshold=3.0
            )
        out.append(_EYE.copy() if m is None else m)
    return np.stack(out).astype(np.float32)


def evaluate_videos(in_frames: np.ndarray, out_frames: np.ndarray) -> dict:
    """The metric triple for (input video, stabilized video), host arrays."""
    pair_out = estimate_pair_transforms_cv(out_frames)
    cross = estimate_cross_transforms_cv(in_frames, out_frames)
    return {
        "stability": float(stability_score(torch.from_numpy(pair_out))),
        "cropping": float(cropping_ratio(torch.from_numpy(cross))),
        "distortion": float(distortion_score(torch.from_numpy(cross))),
    }


__all__ = [
    "cropping_ratio",
    "distortion_score",
    "estimate_cross_transforms_cv",
    "estimate_pair_transforms_cv",
    "evaluate_videos",
    "stability_score",
]
