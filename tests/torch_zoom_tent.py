"""The crop zoom's oracle: the centered bilinear resample as two dense
[n,n] tent matrices, rows first, in full f32 (TF32 off). The renderer
computed the zoom this way until it took the two-tap 1-D passes; the CPU
and card tests hold `zoom_resample` to it."""

import torch

from vstab_torch.core.precision import einsum_f32


def tent_matrix(n: int, scale: torch.Tensor) -> torch.Tensor:
    """[n,n] row-stochastic bilinear sampling matrix for the centered scale
    map src(i) = clamp(c + scale*(i-c), 0, n-1)."""
    i = torch.arange(n, dtype=torch.float32, device=scale.device)
    ctr = (n - 1) / 2.0
    src = torch.clamp(ctr + scale.float() * (i - ctr), 0.0, n - 1.0)
    return torch.clamp(1.0 - torch.abs(src[:, None] - i[None, :]), min=0.0)


def tent_zoom(img: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """out(p) = img(c + scale*(p-c)) for [T,H,W,C] by the two tent products."""
    _, h, w, _ = img.shape
    tmp = einsum_f32("yr,trwc->tywc", tent_matrix(h, scale), img)
    return einsum_f32("xq,tyqc->tyxc", tent_matrix(w, scale), tmp)
