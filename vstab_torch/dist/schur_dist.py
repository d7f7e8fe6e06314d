"""Distributed Schur-complement solve over the time ranks, the port of
`vstab/dist/schur_dist.py`.

The smoothing normal equations are SPD pentadiagonal in time (half-bandwidth
Q=2). The block elimination of `vstab_torch.smooth.schur` makes the
cross-rank structure explicit:

  - each block's interior elimination is local to its rank;
  - blocks couple only through Q-row separators; the couplings that cross a
    rank boundary are 3 band entries, sent one rank forward;
  - each rank's first block adds Schur terms to the previous rank's last
    separator, sent one rank back;
  - the reduced separator system (K_total blocks of QxQ, small) is gathered
    onto every rank, solved there by the block-Thomas loop, and the
    interiors are back-substituted locally.

The local eliminations are those of `schur_solve`, in the same order; only
the separator solve sees gathered data, and the gather keeps rank order.

Band layout: all four operands are length-T_loc slices of GLOBAL length-T
arrays, each superdiagonal stored at its row (d1[t] = A[t+1, t],
d2[t] = A[t+2, t]; the last 1 / 2 entries of the global arrays are zero).
"""

from __future__ import annotations

import torch

from vstab_torch.core.precision import einsum_f32
from vstab_torch.dist.halo import all_gather_cat, ppermute
from vstab_torch.dist.mesh import group_rank
from vstab_torch.smooth.schur import (
    Q,
    block_tridiag_solve,
    blockify,
    interior_eliminate,
    reduce_separator_system,
)


def schur_solve_shard(d0, d1, d2, b, block_len: int, group) -> torch.Tensor:
    """This rank's slice of the distributed SPD pentadiagonal solve.

    All operands [T_loc, M] (the length-T band convention above), T_loc a
    multiple of block_len; `group` is the time group. Returns x [T_loc, M]."""
    t_loc, m = d0.shape
    if t_loc % block_len:
        raise ValueError(f"T_loc={t_loc} not a multiple of block_len={block_len}")
    k_loc = t_loc // block_len
    idx = group_rank(group)

    # The previous rank's trailing couplings (zeros on the first rank, as
    # in the global system).
    prev_d1_last, prev_d2_last2, prev_d2_last = ppermute(torch.stack([d1[-1], d2[-2], d2[-1]]), 1, group)

    # Local blocks. blockify zero-pads the trailing entries of d1 [T-1] and
    # d2 [T-2]: the couplings that cross into the next rank, sent above.
    a_ii, e_l, e_r, d_sep, b_i, b_s = blockify(d0, d1[:-1], d2[:-2], b, block_len)
    e_l[0, :, 0, 1] = prev_d1_last
    e_l[0, :, 0, 0] = prev_d2_last2
    e_l[0, :, 1, 1] = prev_d2_last

    w_l, w_r, w_b, contrib = interior_eliminate(a_ii, e_l, e_r, b_i)
    diag, off, g_l, g_r = reduce_separator_system(d_sep, contrib)
    s_ll, _, s_lr, _, _ = contrib

    # The next rank's first block eliminates into my last separator: its
    # s_ll[0], s_lr[0] and g_l[0] come back as one message (zeros on the
    # last rank).
    firsts = torch.cat([s_ll[0].flatten(), s_lr[0].flatten(), g_l[0].flatten()])
    nxt = ppermute(firsts, -1, group)
    next_s_ll, next_s_lr = nxt[: 2 * m * Q * Q].reshape(2, m, Q, Q)
    next_g_l = nxt[2 * m * Q * Q :].reshape(m, Q)

    diag[-1] += -next_s_ll
    rhs_s = b_s - g_r
    if k_loc > 1:
        rhs_s[: k_loc - 1] += -g_l[1:]
    rhs_s[-1] += -next_g_l
    off_ext = torch.cat([off, -next_s_lr[None]], dim=0)  # [K_loc,...]: S[my last sep, next rank's first]

    # Gather the reduced system (rank order: the same f32 operations on every
    # rank) in one collective and solve it on every rank.
    sizes = (k_loc * m * Q * Q, k_loc * m * Q * Q, k_loc * m * Q)
    packed = all_gather_cat(torch.cat([diag.flatten(), off_ext.flatten(), rhs_s.flatten()])[None], group)
    diag_all, off_all, rhs_all = torch.split(packed, sizes, dim=1)
    diag_all = diag_all.reshape(-1, m, Q, Q)
    off_all = off_all.reshape(-1, m, Q, Q)
    rhs_all = rhs_all.reshape(-1, m, Q)
    k_tot = diag_all.shape[0]
    x_all = block_tridiag_solve(diag_all, off_all[: k_tot - 1], rhs_all)

    # Local back substitution: x_I[k] = w_b[k] - W_L[k] x_S[k-1] - W_R[k] x_S[k].
    x_s = x_all[idx * k_loc : (idx + 1) * k_loc]
    x_prev_last = x_all[idx * k_loc - 1] if idx > 0 else torch.zeros_like(x_all[0])
    x_s_prev = torch.cat([x_prev_last[None], x_s[:-1]], dim=0)
    x_i = (
        w_b
        - einsum_f32("kmip,kmp->kmi", w_l, x_s_prev)
        - einsum_f32("kmip,kmp->kmi", w_r, x_s)
    )
    xb = torch.cat([x_i, x_s], dim=-1)  # [K_loc, M, B]
    return xb.transpose(1, 2).reshape(t_loc, m)


__all__ = ["schur_solve_shard"]
