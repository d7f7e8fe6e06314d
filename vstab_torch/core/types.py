"""Stage contracts of the port, the counterpart of `vstab/core/types.py`.

Conventions
-----------
- Image layout is NHWC / THWC (time-major clips), channels last.
- `Clip.frames` is float32 in [0, 1] on the device; uint8 only at the host
  I/O boundary (`vstab_torch.io.video`) and on the bus of the blocked path.
- Flow is stored as (u, v) = (dx, dy) displacement in pixels of its own
  resolution, channel-last: flow[..., 0] = horizontal, flow[..., 1] = vertical.
- Affine transforms are 2x3 row-major matrices mapping source -> target pixel
  coordinates: [x', y']^T = A[:, :2] @ [x, y]^T + A[:, 2].

The containers are plain frozen dataclasses. The affine helpers broadcast
over leading dimensions of either argument and sum the two products of each
entry in f32 on the CUDA cores (elementwise multiply and add, no matmul), so
no TF32 setting touches them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Clip:
    """A video clip: frames [T, H, W, C] plus fps."""

    frames: torch.Tensor  # [T, H, W, C], float in [0, 1]
    fps: float

    @property
    def num_frames(self) -> int:
        return self.frames.shape[0]

    @property
    def height(self) -> int:
        return self.frames.shape[1]

    @property
    def width(self) -> int:
        return self.frames.shape[2]

    @staticmethod
    def from_array(frames: torch.Tensor, fps: float = 30.0) -> "Clip":
        return Clip(frames=frames, fps=float(fps))


@dataclasses.dataclass(frozen=True)
class FlowField:
    """Dense optical flow between consecutive frame pairs.

    flow[t] maps frame t -> frame t+1: pixel p in frame t corresponds to
    p + flow[t, p] in frame t+1. Shape [T-1, H, W, 2] (or [N, H, W, 2] for a
    batch of independent pairs), channels (u=dx, v=dy).
    """

    flow: torch.Tensor  # [N, H, W, 2]

    @property
    def u(self) -> torch.Tensor:
        return self.flow[..., 0]

    @property
    def v(self) -> torch.Tensor:
        return self.flow[..., 1]


@dataclasses.dataclass(frozen=True)
class CameraPath:
    """Per-frame global camera motion as a chain of 2x3 affine transforms:
    transforms[t] maps frame-0 coordinates to frame-t coordinates. [T, 2, 3]."""

    transforms: torch.Tensor  # [T, 2, 3]

    @property
    def num_frames(self) -> int:
        return self.transforms.shape[0]


@dataclasses.dataclass(frozen=True)
class VertexGrid:
    """Per-frame mesh-vertex positions of the sparse-LS smoothing problem:
    positions[t, i, j] = (x, y) of vertex (i, j) at time t. [T, GH, GW, 2]."""

    positions: torch.Tensor  # [T, GH, GW, 2]


def identity_affine(dtype=torch.float32, device=None) -> torch.Tensor:
    """The 2x3 identity transform."""
    return torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=dtype, device=device)


def _lin_apply(lin: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """lin [...,2,2] applied to vec [...,2]: lin[i,0] vec[0] + lin[i,1] vec[1]
    (no [...,2,2] intermediate: vec may be a full frame of points)."""
    return lin[..., :, 0] * vec[..., None, 0] + lin[..., :, 1] * vec[..., None, 1]


def compose_affine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose 2x3 affines: the result applies b first, then a (a o b)."""
    la, lb = a[..., :2], b[..., :2]
    lin = la[..., :, 0:1] * lb[..., 0:1, :] + la[..., :, 1:2] * lb[..., 1:2, :]
    trans = _lin_apply(la, b[..., 2]) + a[..., 2]
    return torch.cat([lin, trans[..., None]], dim=-1)


def invert_affine(a: torch.Tensor) -> torch.Tensor:
    """Invert a (batch of) 2x3 affine transform(s)."""
    lin = a[..., :2]
    det = lin[..., 0, 0] * lin[..., 1, 1] - lin[..., 0, 1] * lin[..., 1, 0]
    inv_det = 1.0 / det
    inv_lin = (
        torch.stack(
            [
                torch.stack([lin[..., 1, 1], -lin[..., 0, 1]], dim=-1),
                torch.stack([-lin[..., 1, 0], lin[..., 0, 0]], dim=-1),
            ],
            dim=-2,
        )
        * inv_det[..., None, None]
    )
    inv_trans = -_lin_apply(inv_lin, a[..., 2])
    return torch.cat([inv_lin, inv_trans[..., None]], dim=-1)


def apply_affine(a: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply 2x3 affine(s) to points xy [..., 2] -> [..., 2]."""
    return _lin_apply(a[..., :2], xy) + a[..., 2]


__all__ = [
    "Clip",
    "FlowField",
    "CameraPath",
    "VertexGrid",
    "identity_affine",
    "compose_affine",
    "invert_affine",
    "apply_affine",
]
