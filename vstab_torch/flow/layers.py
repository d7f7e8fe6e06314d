"""Flax-compatible convolution layers on channels-last tensors.

`Conv` is `flax.linen.Conv` with 'SAME' padding (a stride-2 3x3 conv on an
even size pads (0, 1), not (1, 1)); `ConvTranspose` is `flax.linen.
ConvTranspose` with 4x4 kernels, stride 2 and 'SAME' padding, which equals
`conv_transpose2d(padding=1)` once the flax kernel is flipped in space
(done at load time, `vstab_torch.utils.checkpoint.params_from_jax`).

Both take and return [N,H,W,C] tensors and compute in their `dtype`, with
the weights cast to it, as flax's `dtype=` does. A channels-last tensor
permuted to NCHW is in torch's channels_last memory format, which cuDNN
convolves without a relayout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> None:
    # flax's default kernel init: truncated normal with variance 1/fan_in.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _same_pads(size: int, k: int, stride: int, dilation: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    def __init__(
        self, cin: int, cout: int, k: int = 3, stride: int = 1, dilation: int = 1,
        dtype: torch.dtype = torch.bfloat16, device: Optional[str] = None,
    ):
        super().__init__()
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        if self.weight.device.type != "meta":
            self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's defaults: lecun-normal kernel, zero bias."""
        cout, cin, k, _ = self.weight.shape
        with torch.no_grad():
            _lecun_normal_(self.weight, cin * k * k, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        ph = _same_pads(x.shape[1], k, self.stride, self.dilation)
        pw = _same_pads(x.shape[2], k, self.stride, self.dilation)
        xc = x.to(self.dtype).permute(0, 3, 1, 2)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        y = F.conv2d(
            xc, self.weight.to(self.dtype), self.bias.to(self.dtype),
            stride=self.stride, padding=padding, dilation=self.dilation,
        )
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """4x4, stride 2, 'SAME': [N,H,W,Cin] -> [N,2H,2W,Cout]. Weight layout
    (in, out, kh, kw), already flipped in space."""

    def __init__(
        self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16,
        device: Optional[str] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        if self.weight.device.type != "meta":
            self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            _lecun_normal_(self.weight, self.weight.shape[0] * 16, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(
            x.to(self.dtype).permute(0, 3, 1, 2),
            self.weight.to(self.dtype), self.bias.to(self.dtype),
            stride=2, padding=1,
        )
        return y.permute(0, 2, 3, 1)


__all__ = ["Conv", "ConvTranspose", "leaky"]
