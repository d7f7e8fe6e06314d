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

`predict` runs the networks' f32 prediction heads (3x3 convolutions down to
2 channels): by `conv3x3_to2`, a matrix product and a col2im, where autograd
records no graph; by the head's `Conv` where it does.
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


def conv3x3_to2(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A 3x3, stride-1, 'SAME' convolution from C channels to 2, in f32:
    [N,H,W,C] -> [N,H,W,2], plus `residual` [N,H,W,2] where given. `weight`
    is [2,C,3,3] (the `Conv` layout), `bias` [2].

    One matrix product gives every pixel's nine taps of both outputs,
    Z = x [NHW,C] @ Wk [C,18]; one `F.fold` (col2im) adds each tap into the
    pixel it reaches. fold sends tap (ki, kj) of pixel p to p + (ki-1, kj-1),
    where the convolution takes tap (i, j) of pixel p from p + (i-1, j-1):
    the same sum once Wk's taps are flipped in space (ki = 2 - i). Then the
    bias, then the residual. Only the order of the f32 sums differs from the
    convolution's. The product follows the process's TF32 flag, which the
    networks' forwards pin off (`pin_full_f32`)."""
    n, h, w, c = x.shape
    if weight.shape != (2, c, 3, 3):
        raise ValueError(f"conv3x3_to2 takes a [2,{c},3,3] weight, got {list(weight.shape)}")
    wk = weight.flip(2, 3).transpose(0, 1).reshape(c, 18)  # [C, (out, ki, kj)]
    z = x.reshape(n * h * w, c) @ wk
    y = F.fold(z.view(n, h * w, 18).transpose(1, 2), (h, w), kernel_size=3, padding=1)
    out = torch.add(y.permute(0, 2, 3, 1), bias, out=x.new_empty((n, h, w, 2)))
    if residual is not None:
        out += residual
    return out


def predict(head: Conv, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An f32 prediction head (a 3x3, stride-1, dilation-1 `Conv` to 2
    channels), head(x) + residual: `conv3x3_to2` where autograd records no
    graph (inference, `torch.no_grad`), the head's convolution where it
    records one (a training step)."""
    x = x.float()
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, head.weight, head.bias, residual)
    ):
        y = head(x)
        return y if residual is None else y + residual
    return conv3x3_to2(x, head.weight.float(), head.bias.float(), residual)


__all__ = ["Conv", "ConvTranspose", "conv3x3_to2", "leaky", "predict"]
