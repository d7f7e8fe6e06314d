"""Config tree of the port."""

from vstab_torch.core.config import (
    Config,
    DistConfig,
    FlowConfig,
    GmflowConfig,
    IOConfig,
    RaftConfig,
    RenderConfig,
    SmoothConfig,
    preset,
)

__all__ = [
    "Config",
    "DistConfig",
    "FlowConfig",
    "GmflowConfig",
    "IOConfig",
    "RaftConfig",
    "RenderConfig",
    "SmoothConfig",
    "preset",
]
