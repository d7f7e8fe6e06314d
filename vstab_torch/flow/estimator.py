"""Per-level flow estimator and 2x up-block, the port of
`vstab/flow/estimator.py`.

DenseNet-style conv stack over [cost volume, f1, upsampled flow, upsampled
features]; each conv's output is concatenated in front of its input
(`[y, x]`). `predict_flow` and `upflow` compute in f32, the rest in `dtype`;
`predict_flow` goes through `layers.predict`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vstab_torch.flow.layers import Conv, ConvTranspose, leaky, predict


class FlowEstimator(nn.Module):
    def __init__(
        self, cin: int, channels: Sequence[int] = (128, 128, 96, 64, 32),
        dtype: torch.dtype = torch.bfloat16, device: Optional[str] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        c = cin
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", Conv(c, ch, dtype=dtype, device=device))
            c += ch
        self.out_channels = c
        self.predict_flow = Conv(c, 2, dtype=torch.float32, device=device)

    def forward(
        self, x: torch.Tensor, upflow: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (flow [N,H,W,2] f32, last features [N,H,W,out_channels]);
        the flow is the level's prediction plus `upflow` where given."""
        x = x.to(self.dtype)
        for i in range(self.n):
            y = leaky(getattr(self, f"conv{i}")(x))
            x = torch.cat([y, x], dim=-1)
        return predict(self.predict_flow, x, upflow), x


class UpBlock(nn.Module):
    """2x transposed-conv upsampling of flow (f32) and decoder features."""

    def __init__(
        self, feat_in: int, feat_channels: int = 2,
        dtype: torch.dtype = torch.bfloat16, device: Optional[str] = None,
    ):
        super().__init__()
        self.upflow = ConvTranspose(2, 2, dtype=torch.float32, device=device)
        self.upfeat = ConvTranspose(feat_in, feat_channels, dtype=dtype, device=device)

    def forward(self, flow: torch.Tensor, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.upflow(flow), self.upfeat(feat)


__all__ = ["FlowEstimator", "UpBlock"]
