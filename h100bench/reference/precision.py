"""Arithmetic policies of the reference and of its controls.

- "f32": float32 throughout, TF32 off for matmuls and cuDNN convolutions.
- "tf32": the operands of every convolution rounded to TF32 (10 mantissa
  bits, to nearest even) and TF32 on for the card's float32 matmuls and
  convolutions: the control of a configuration that states float32 with
  TF32 off. The rounding is written out, so the control reads the same on
  the CPU.
- "fp8": the operands of every layer that the configuration states in
  bfloat16 rounded to float8 e4m3 with one scale a tensor (amax / 448), the
  products summed in float32: the control of a configuration that states
  bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

POLICIES = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for float32 matmuls and cuDNN convolutions on or off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / _E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 mantissa bits, half to even."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def lowp(policy: str, x: torch.Tensor, stated_bf16: bool = True) -> torch.Tensor:
    """A convolution operand x under `policy`; `stated_bf16` says whether the
    configuration states the layer in bfloat16. The rounding passes the
    gradient through unchanged."""
    x = x.float()
    if policy == "fp8" and stated_bf16:
        return x + (fp8_round(x.detach()) - x.detach())
    if policy == "tf32":
        return x + (tf32_round(x.detach()) - x.detach())
    return x
