"""Dilated context (refinement) network, the port of `vstab/flow/context.py`.

Consumes the finest estimator's features and flow, emits flow + residual.
The fixed channels (128,128,128,96,64,32) are zipped with the configured
dilations, so a shorter dilation tuple uses fewer layers, as in the
reference. `predict_res` computes in f32 (through `layers.predict`), the
rest in `dtype`. With `pad`, the input [feat, flow] carries that many zero
channels at its end (`pwcnet.prepare`'s layout), and `dconv0` reads them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from vstab_torch.flow.layers import Conv, leaky, predict

CHANNELS = (128, 128, 128, 96, 64, 32)


class ContextNet(nn.Module):
    def __init__(
        self, cin: int, dilations: Sequence[int] = (1, 2, 4, 8, 16, 1),
        channels: Sequence[int] = CHANNELS, dtype: torch.dtype = torch.bfloat16,
        device: Optional[str] = None, pad: int = 0,
    ):
        super().__init__()
        self.dtype, self.pad = dtype, pad
        layers = list(zip(channels, dilations))
        self.n = len(layers)
        c = cin + pad
        for i, (ch, dil) in enumerate(layers):
            self.add_module(f"dconv{i}", Conv(c, ch, dilation=dil, dtype=dtype, device=device))
            c = ch
        self.predict_res = Conv(c, 2, dtype=torch.float32, device=device)

    def forward(self, feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        parts = [feat.to(self.dtype), flow.to(self.dtype)]
        if self.pad:
            parts.append(feat.new_zeros((*feat.shape[:-1], self.pad), dtype=self.dtype))
        x = torch.cat(parts, dim=-1)
        for i in range(self.n):
            x = leaky(getattr(self, f"dconv{i}")(x))
        return predict(self.predict_res, x, flow)


__all__ = ["ContextNet"]
