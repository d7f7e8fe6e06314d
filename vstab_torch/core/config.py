"""Frozen config tree of the port: the same dataclasses, field names,
defaults, `to_json`/`from_json` and `preset` as `vstab/core/config.py`, so a
config that the JAX package wrote as JSON loads here unchanged.

`RaftConfig` and `GmflowConfig` are the port's own: flow networks (RAFT,
GMFlow) that `Config.flow` may hold in place of `FlowConfig`, written to JSON
with `"net": "raft"` or `"net": "gmflow"` and read back from it. The JAX
package has no such network, and every JSON it writes loads as before.

`FlowConfig.kernel_impl` and `RenderConfig.kernel_impl` are kept only for
that JSON compatibility. The port never reads them: every kernel wrapper
dispatches on the device of the tensor it is given (the CUDA kernel for a
CUDA tensor, the plain torch version for a CPU tensor).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """PWC-Net-style flow network configuration (SURVEY.md §2.1)."""

    # Channels of the feature pyramid, finest (level 1) -> coarsest.
    pyramid_channels: Tuple[int, ...] = (16, 32, 64, 96, 128, 196)
    # Cost-volume search radius d; (2d+1)^2 correlation channels.
    search_radius: int = 4
    # Channels of the dense-block flow estimator convs.
    estimator_channels: Tuple[int, ...] = (128, 128, 96, 64, 32)
    # Dilations of the context (refinement) network.
    context_dilations: Tuple[int, ...] = (1, 2, 4, 8, 16, 1)
    # Finest pyramid level at which flow is estimated (PWC-Net: 2 => H/4).
    output_level: int = 2
    # Max |flow| (in level pixels) used by the bounded Pallas warp.
    warp_max_disp: int = 8
    # 'pallas' | 'xla' — kernel implementation for cost volume & warp.
    kernel_impl: str = "pallas"
    # Compute dtype for the network ('bfloat16' keeps MXU fed; params stay f32).
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """RAFT (Teed & Deng, ECCV 2020, arXiv 2003.12039), the "large" model:
    all-pairs correlation at 1/8 resolution, a pyramid lookup and
    recurrent ConvGRU updates (`vstab_torch/flow/raft.py`)."""

    net: str = "raft"
    # GRU hidden state and context feature channels: RAFT large's 128 each,
    # the only widths its layers take.
    hidden: int = 128
    context: int = 128
    # Correlation pyramid levels and lookup radius: levels * (2r+1)^2 channels.
    corr_levels: int = 4
    corr_radius: int = 4
    # Recurrent updates (RAFT's demo.py: 20).
    iters: int = 20
    # Encoders and update block; the correlation, lookup, coordinates and
    # convex upsampling stay float32 (RAFT's --mixed_precision split).
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.net != "raft":
            raise ValueError(f"RaftConfig.net must be 'raft', got {self.net!r}")
        if (self.hidden, self.context) != (128, 128):
            raise ValueError(
                f"RaftConfig: hidden {self.hidden} and context {self.context}; RAFT large "
                "has 128 of each, and its layers take no other width"
            )


@dataclasses.dataclass(frozen=True)
class GmflowConfig:
    """GMFlow with refinement (Xu et al., CVPR 2022, arXiv 2111.13680;
    haofeixu/gmflow, checkpoints `gmflow_with_refine_*`): a CNN backbone at
    1/8 and 1/4, a 6-block Swin-style transformer at each scale, global
    matching and propagation at 1/8, local matching and propagation at 1/4,
    convex upsampling x4 (`vstab_torch/flow/gmflow.py`, which holds the
    published settings: its layers take no others)."""

    net: str = "gmflow"
    # Backbone, transformer and upsampler convolutions; the matchings,
    # propagations, flow and convex upsampling stay float32.
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.net != "gmflow":
            raise ValueError(f"GmflowConfig.net must be 'gmflow', got {self.net!r}")


@dataclasses.dataclass(frozen=True)
class SmoothConfig:
    """Motion smoothing configuration (SURVEY.md §2.1, §3.3)."""

    # 'affine'  — global affine path + low-pass (config 1 / PR1 path)
    # 'sparse_ls' — grid motion field, sparse-LS + Schur solve (full path)
    method: str = "sparse_ls"
    # Gaussian smoothing sigma (frames) for the affine path.
    affine_sigma: float = 9.0
    # Mesh-grid size for sparse-LS smoothing.
    grid_size: Tuple[int, int] = (12, 16)  # (GH, GW)
    # IRLS rounds of the robust (soft-median) vertex pooling: foreground
    # objects moving independently of the camera are down-weighted instead
    # of dragging the vertex profiles (VERDICT r4 item 3). 0 = plain mean.
    robust_iters: int = 2
    # Term weights: data (follow original), temporal smoothness, spatial
    # rigidity. Tuned against the round-4 flow checkpoint: the round-3
    # weights (40/10/200) were calibrated against a net that systematically
    # UNDERestimated large shake — with accurate motion they under-smooth
    # (stability 0.72 vs 0.88 on the 160x192 integration clip; swept in
    # round 4, lambda_smooth=400/lambda_accel=4000 is the cross-family
    # optimum with unchanged cropping/distortion).
    lambda_data: float = 1.0
    lambda_smooth: float = 400.0
    lambda_rigid: float = 10.0
    # Second-order (acceleration) temporal term weight; 0 disables.
    lambda_accel: float = 4000.0
    # Schur temporal block length (frames per elimination block).
    block_len: int = 32
    # Tikhonov damping added to normal equations (f32 conditioning).
    damping: float = 1e-4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Full-frame render / crop policy (SURVEY.md §2.1 "Full-frame renderer")."""

    # 'fixed' — fixed margin crop; 'auto' — crop to the common valid region;
    # 'none' — keep full frame with border fill.
    crop_mode: str = "fixed"
    fixed_crop_ratio: float = 0.9  # keep central 90% for crop_mode='fixed'
    border_value: float = 0.0
    # Bound (px) on the per-frame mean-removed residual displacement handled
    # exactly by the two-pass render warp (kernels/warp1d.py). With
    # adaptive_max_disp this is the FLOOR; the actual bound is derived from
    # the solved path per run (render.residual_disp_bound / pick_max_disp)
    # so >16px shake degrades gracefully instead of punching border-colored
    # holes (VERDICT r3 item 7).
    max_residual_disp: int = 16
    # Derive the render-warp displacement bound from the solved path.
    adaptive_max_disp: bool = True
    # Hard cap for the adaptive bound. 255 is the largest bucket the 1D warp
    # kernels tile (C*(2d+2) must divide the wide-path tile lanes;
    # kernels/warp1d.py) — it covers ~0.25 rad-equivalents of residual at 4K.
    max_disp_limit: int = 255
    # 'auto' | 'pallas' | 'xla' — render warp kernel implementation.
    kernel_impl: str = "auto"

    def __post_init__(self):
        if self.crop_mode not in ("fixed", "auto", "none"):
            raise ValueError(
                f"crop_mode must be 'fixed'|'auto'|'none', got {self.crop_mode!r}"
            )


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Mesh / sharding configuration (SURVEY.md §2.2)."""

    # Mesh axis sizes; None = use all local devices on that axis.
    data_axis: int = 1  # clip-level DP
    time_axis: int = 1  # temporal-block parallelism
    # Temporal block length (frames) per shard for long-clip blocking.
    # (Pair flow needs exactly a 1-frame seam halo — dist/halo.extend_right
    # — so there is no halo knob; VERDICT r4 weak-5 removed the dead one.)
    time_block_len: int = 64
    # Multi-host bring-up (jax.distributed.initialize) — None = single host.
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclasses.dataclass(frozen=True)
class IOConfig:
    host_chunk_frames: int = 256  # frames decoded per host->device chunk
    output_codec: str = "mp4v"


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level config: the one jit-static argument of vstab.pipeline."""

    flow: Union[FlowConfig, RaftConfig, GmflowConfig] = FlowConfig()
    smooth: SmoothConfig = SmoothConfig()
    render: RenderConfig = RenderConfig()
    dist: DistConfig = DistConfig()
    io: IOConfig = IOConfig()
    seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)

        def _mk(cls, sub):
            kw = dict(sub)
            for f in dataclasses.fields(cls):
                if f.name in kw and isinstance(kw[f.name], list):
                    kw[f.name] = tuple(
                        tuple(x) if isinstance(x, list) else x for x in kw[f.name]
                    )
            return cls(**kw)

        flow = d.get("flow", {})
        nets = {"raft": RaftConfig, "gmflow": GmflowConfig}
        return Config(
            flow=_mk(nets.get(flow.get("net"), FlowConfig), flow),
            smooth=_mk(SmoothConfig, d.get("smooth", {})),
            render=_mk(RenderConfig, d.get("render", {})),
            dist=_mk(DistConfig, d.get("dist", {})),
            io=_mk(IOConfig, d.get("io", {})),
            seed=d.get("seed", 0),
        )


# Preset configs mirroring the driver's milestone ladder (BASELINE.json:6-12).
def preset(name: str) -> Config:
    if name == "affine_480p":  # config 1 (PR1 ref)
        return Config(
            smooth=SmoothConfig(method="affine"),
            flow=FlowConfig(kernel_impl="xla", compute_dtype="float32"),
        )
    if name == "full_720p":  # config 2
        return Config()
    if name == "blocked_1080p":  # config 3
        return Config(dist=DistConfig(time_block_len=64))
    if name == "dp_sweep":  # config 4
        return Config(dist=DistConfig(data_axis=8))
    if name == "multihost_4k":  # config 5
        return Config(dist=DistConfig(time_axis=8, time_block_len=64))
    raise ValueError(f"unknown preset: {name}")


__all__ = [
    "FlowConfig",
    "RaftConfig",
    "GmflowConfig",
    "SmoothConfig",
    "RenderConfig",
    "DistConfig",
    "IOConfig",
    "Config",
    "preset",
]
