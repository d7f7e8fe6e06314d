"""Halo exchange between neighbouring time ranks, the port of
`vstab/dist/halo.py`.

Each rank holds a contiguous slice of a clip's frames (time on axis 0). Flow
at a slice's end needs the next slice's first frame, and a cumulative sum
over time needs the totals of the slices before. The reference's `ppermute`
becomes one `batch_isend_irecv` between neighbours of the time group, its
`all_gather` a `dist.all_gather`. A rank with no partner receives zeros, and
a world of one posts no operation.

Every function takes the time group (`Mesh.time_group`) where the reference
takes the axis name. Tensors stay on their device: gloo carries CPU tensors,
NCCL CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vstab_torch.dist.mesh import global_rank, group_rank, group_size


def ppermute(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """Rank i of `group` receives rank (i - shift)'s `x`; a rank with no such
    partner receives zeros. shift=+1 passes forward (i -> i+1), -1 back."""
    n, i = group_size(group), group_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= i + shift < n:
        ops.append(dist.P2POp(dist.isend, x, global_rank(group, i + shift), group))
    if 0 <= i - shift < n:
        ops.append(dist.P2POp(dist.irecv, out, global_rank(group, i - shift), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` stacked along axis 0 in rank order: [n*x.shape[0], ...]
    (the reference's `all_gather(..., tiled=True)`)."""
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def shift_from_next(x: torch.Tensor, k: int, group) -> torch.Tensor:
    """The FIRST k time steps of the next rank's slice (i+1 -> i); the last
    rank receives zeros. Returns [k, ...]."""
    return ppermute(x[:k], -1, group)


def shift_from_prev(x: torch.Tensor, k: int, group) -> torch.Tensor:
    """The LAST k time steps of the previous rank's slice (i-1 -> i); the
    first rank receives zeros. Returns [k, ...]."""
    return ppermute(x[-k:], 1, group)


def extend_right(x: torch.Tensor, k: int, group) -> torch.Tensor:
    """Append the next rank's first k steps: [T_loc,...] -> [T_loc+k,...]. On
    the last rank the appended steps repeat its last step (the clip's end is a
    freeze frame, as on one device)."""
    nxt = shift_from_next(x, k, group)
    if group_rank(group) == group_size(group) - 1:
        nxt = x[-1:].expand(nxt.shape)
    return torch.cat([x, nxt], dim=0)


def exclusive_prefix_sum(total: torch.Tensor, group) -> torch.Tensor:
    """Sum of `total` over the ranks strictly BEFORE this one: the cross-rank
    half of a distributed cumulative sum (each rank adds it to its local
    cumsum). One all_gather of the small per-rank totals."""
    n, i = group_size(group), group_rank(group)
    all_totals = all_gather_cat(total[None], group)  # [n, ...]
    mask = (torch.arange(n, device=total.device) < i).to(total.dtype)
    return torch.tensordot(mask, all_totals, dims=1)


__all__ = [
    "all_gather_cat",
    "exclusive_prefix_sum",
    "extend_right",
    "ppermute",
    "shift_from_next",
    "shift_from_prev",
]
