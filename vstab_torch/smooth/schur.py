"""Schur-complement block elimination for the smoothing normal equations,
the port of `vstab/smooth/schur.py`.

Solves the same batched SPD pentadiagonal systems as `banded_solve_scan` by
domain decomposition over temporal blocks of length B: each block's last
Q=2 rows are its separator; all interiors are factored and eliminated as
batched dense Cholesky solves; the reduced separator system is
block-tridiagonal with 2x2 blocks and is solved by a block-Thomas loop; the
interiors are then back-substituted in one batched step.

Band layout matches `vstab_torch.smooth.banded`: d0 [T,M], d1 [T-1,M],
d2 [T-2,M].
"""

from __future__ import annotations

import torch

from vstab_torch.core.precision import einsum_f32

Q = 2  # half-bandwidth == separator width


def _pad_system(d0, d1, d2, b, block_len):
    """Pad T up to a multiple of block_len with identity rows (x=0)."""
    t, m = d0.shape
    tp = -(-t // block_len) * block_len
    pad = tp - t
    z = lambda: torch.zeros((pad, m), dtype=d0.dtype, device=d0.device)
    d0p = torch.cat([d0, torch.ones((pad, m), dtype=d0.dtype, device=d0.device)], dim=0)
    return d0p, torch.cat([d1, z()]), torch.cat([d2, z()]), torch.cat([b, z()]), tp


def blockify(d0, d1, d2, b, block_len: int):
    """Per-block dense operators from the band diagonals (batched over M):
    a_ii [K,M,m,m] interiors, e_l / e_r [K,M,m,Q] couplings to separators
    k-1 / k, d_sep [K,M,Q,Q], b_i [K,M,m], b_s [K,M,Q]; m = block_len - Q."""
    bl = block_len
    m = bl - Q
    t, nm = d0.shape
    k = t // bl
    kw = dict(dtype=d0.dtype, device=d0.device)
    d0r = d0.reshape(k, bl, nm)
    d1r = torch.cat([d1, torch.zeros((1, nm), **kw)]).reshape(k, bl, nm)
    d2r = torch.cat([d2, torch.zeros((2, nm), **kw)]).reshape(k, bl, nm)
    br = b.reshape(k, bl, nm)

    a_ii = torch.zeros((k, nm, m, m), **kw)
    ii = torch.arange(m, device=d0.device)
    a_ii[:, :, ii, ii] = d0r[:, :m].transpose(1, 2)
    a_ii[:, :, ii[1:], ii[:-1]] = d1r[:, : m - 1].transpose(1, 2)
    a_ii[:, :, ii[:-1], ii[1:]] = d1r[:, : m - 1].transpose(1, 2)
    a_ii[:, :, ii[2:], ii[:-2]] = d2r[:, : m - 2].transpose(1, 2)
    a_ii[:, :, ii[:-2], ii[2:]] = d2r[:, : m - 2].transpose(1, 2)

    # Right coupling: interior rows m-2, m-1 -> separator rows 0, 1.
    e_r = torch.zeros((k, nm, m, Q), **kw)
    e_r[:, :, m - 2, 0] = d2r[:, m - 2]
    e_r[:, :, m - 1, 0] = d1r[:, m - 1]
    e_r[:, :, m - 1, 1] = d2r[:, m - 1]

    # Left coupling: interior rows 0, 1 -> separator k-1 rows 0, 1, from the
    # previous block's trailing diagonals.
    zrow = torch.zeros((1, nm), **kw)
    e_l = torch.zeros((k, nm, m, Q), **kw)
    e_l[:, :, 0, 1] = torch.cat([zrow, d1r[:-1, bl - 1]])  # A[kB, kB-1]
    e_l[:, :, 0, 0] = torch.cat([zrow, d2r[:-1, bl - 2]])  # A[kB, kB-2]
    e_l[:, :, 1, 1] = torch.cat([zrow, d2r[:-1, bl - 1]])  # A[kB+1, kB-1]

    d_sep = torch.zeros((k, nm, Q, Q), **kw)
    d_sep[:, :, 0, 0] = d0r[:, m]
    d_sep[:, :, 1, 1] = d0r[:, m + 1]
    d_sep[:, :, 0, 1] = d1r[:, m]
    d_sep[:, :, 1, 0] = d1r[:, m]

    b_i = br[:, :m].transpose(1, 2)
    b_s = br[:, m:].transpose(1, 2)
    return a_ii, e_l, e_r, d_sep, b_i, b_s


def interior_eliminate(a_ii, e_l, e_r, b_i):
    """Factor the interiors; return (w_l, w_r, w_b) = A_II^{-1} (E_L, E_R,
    b_I) and the separator contributions (s_ll, s_rr, s_lr, g_l, g_r)."""
    chol = torch.linalg.cholesky(a_ii)

    def chosolve(rhs):
        y = torch.linalg.solve_triangular(chol, rhs, upper=False)
        return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)

    w_l = chosolve(e_l)
    w_r = chosolve(e_r)
    w_b = chosolve(b_i[..., None])[..., 0]
    tdot = lambda a, b: einsum_f32("kmip,kmiq->kmpq", a, b)
    s_ll = tdot(e_l, w_l)
    s_rr = tdot(e_r, w_r)
    s_lr = tdot(e_l, w_r)
    g_l = einsum_f32("kmip,kmi->kmp", e_l, w_b)
    g_r = einsum_f32("kmip,kmi->kmp", e_r, w_b)
    return w_l, w_r, w_b, (s_ll, s_rr, s_lr, g_l, g_r)


def _inv2x2(a: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 2x2 inverse."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_det = 1.0 / det
    out = torch.stack(
        [
            torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
            torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
        ],
        dim=-2,
    )
    return out * inv_det[..., None, None]


def block_tridiag_solve(diag: torch.Tensor, off: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Block-Thomas solve: diag [K,M,Q,Q], off [K-1,M,Q,Q] (= S[k,k+1]),
    rhs [K,M,Q] -> x [K,M,Q]; a loop over the (small) K."""
    k = diag.shape[0]
    offp = torch.cat([torch.zeros_like(off[:1]), off], dim=0)  # S[k-1, k]
    dprev = torch.eye(Q, dtype=diag.dtype, device=diag.device).expand(diag.shape[1:])
    yprev = torch.zeros_like(rhs[0])
    dfac, yfac = [], []
    for i in range(k):
        factor = einsum_f32("mqp,mpr->mqr", offp[i].transpose(-1, -2), _inv2x2(dprev))
        dprev = diag[i] - einsum_f32("mqr,mrp->mqp", factor, offp[i])
        yprev = rhs[i] - einsum_f32("mqr,mr->mq", factor, yprev)
        dfac.append(dprev)
        yfac.append(yprev)

    offn = torch.cat([off, torch.zeros_like(off[:1])], dim=0)
    xnext = torch.zeros_like(rhs[0])
    xs = [None] * k
    for i in range(k - 1, -1, -1):
        rhs_k = yfac[i] - einsum_f32("mqr,mr->mq", offn[i], xnext)
        xnext = einsum_f32("mqr,mr->mq", _inv2x2(dfac[i]), rhs_k)
        xs[i] = xnext
    return torch.stack(xs, dim=0)


def reduce_separator_system(d_sep, contrib):
    """Assemble the reduced block-tridiagonal separator system.

    Separator k diag: D_k - s_rr[k] - s_ll[k+1]; off-diag (k-1,k): -s_lr[k].
    Returns (diag [K,M,Q,Q], off [K-1,M,Q,Q] as S[k,k+1], g_l, g_r)."""
    s_ll, s_rr, s_lr, g_l, g_r = contrib
    k = d_sep.shape[0]
    diag = d_sep - s_rr
    diag[: k - 1] += -s_ll[1:]
    off = -s_lr[1:]  # off[k] = S[k, k+1], from block k+1's elimination
    return diag, off, g_l, g_r


def schur_solve(d0, d1, d2, b, block_len: int = 32) -> torch.Tensor:
    """Solve SPD pentadiagonal A x = b by Schur-complement block elimination.
    Same contract as `banded_solve_scan`; requires block_len >= 2*Q + 1."""
    t = d0.shape[0]
    d0p, d1p, d2p, bp, tp = _pad_system(d0, d1, d2, b, block_len)
    a_ii, e_l, e_r, d_sep, b_i, b_s = blockify(d0p, d1p, d2p, bp, block_len)
    w_l, w_r, w_b, contrib = interior_eliminate(a_ii, e_l, e_r, b_i)

    k = d_sep.shape[0]
    diag, off, g_l, g_r = reduce_separator_system(d_sep, contrib)
    rhs_s = b_s - g_r  # rhs_S[k] = b_S[k] - g_r[k] - g_l[k+1]
    rhs_s[: k - 1] += -g_l[1:]

    x_s = block_tridiag_solve(diag, off, rhs_s)  # [K, M, Q]
    # x_I[k] = w_b[k] - W_L[k] x_S[k-1] - W_R[k] x_S[k]
    x_s_prev = torch.cat([torch.zeros_like(x_s[:1]), x_s[:-1]], dim=0)
    x_i = (
        w_b
        - einsum_f32("kmip,kmp->kmi", w_l, x_s_prev)
        - einsum_f32("kmip,kmp->kmi", w_r, x_s)
    )
    xb = torch.cat([x_i, x_s], dim=-1)  # [K, M, B]
    return xb.transpose(1, 2).reshape(tp, -1)[:t]


__all__ = [
    "block_tridiag_solve",
    "blockify",
    "interior_eliminate",
    "reduce_separator_system",
    "schur_solve",
]
