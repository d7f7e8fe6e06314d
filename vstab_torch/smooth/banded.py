"""Batched symmetric pentadiagonal solve, the port of `vstab/smooth/banded.py`.

Systems are SPD, size T (time), half-bandwidth 2, batched over M columns
(spatial eigenmodes x components) on the last axis, so every step of the
time loop is one [M]-wide tensor op.

Band layout for A (per batch column):
  d0[i] = A[i, i]      (i in [0, T))
  d1[i] = A[i+1, i]    (i in [0, T-1))
  d2[i] = A[i+2, i]    (i in [0, T-2))
"""

from __future__ import annotations

import torch


def banded_matvec(d0: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for symmetric pentadiagonal A; all [T(-k), M]."""
    y = d0 * x
    y[1:] += d1 * x[:-1]
    y[:-1] += d1 * x[1:]
    y[2:] += d2 * x[:-2]
    y[:-2] += d2 * x[2:]
    return y


def banded_solve_scan(
    d0: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Solve A x = b, A SPD pentadiagonal, by sequential LDL: a Python loop
    over T with the recurrences of `vstab.smooth.banded.banded_solve_scan`
      l2_i = c_{i-2} / alpha_{i-2}
      l1_i = (b_{i-1} - l2_i * u1_{i-2}) / alpha_{i-1}
      alpha_i = a_i - l2_i * c_{i-2} - l1_i * u1_{i-1}
      u1_i = b_i - l1_i * c_{i-1}
      y_i  = rhs_i - l2_i * y_{i-2} - l1_i * y_{i-1}
    and back substitution x_i = (y_i - u1_i x_{i+1} - c_i x_{i+2}) / alpha_i."""
    t, m = d0.shape
    zero = torch.zeros((1, m), dtype=d0.dtype, device=d0.device)
    one = torch.ones((1, m), dtype=d0.dtype, device=d0.device)
    b_prev = torch.cat([zero, d1], dim=0)  # b_{i-1}
    c_prev2 = torch.cat([zero, zero, d2], dim=0)  # c_{i-2}
    c_prev1 = torch.cat([zero, d2, zero], dim=0)  # c_{i-1}
    b_cur = torch.cat([d1, zero], dim=0)  # b_i (unused at i=T-1)

    a1, a2 = one[0], one[0]
    u1p1 = u1p2 = y1 = y2 = zero[0]
    alphas, u1s, ys = [], [], []
    for i in range(t):
        l2 = c_prev2[i] / a2
        l1 = (b_prev[i] - l2 * u1p2) / a1
        alpha = d0[i] - l2 * c_prev2[i] - l1 * u1p1
        u1 = b_cur[i] - l1 * c_prev1[i]
        y = b[i] - l2 * y2 - l1 * y1
        a1, a2 = alpha, a1
        u1p1, u1p2 = u1, u1p1
        y1, y2 = y, y1
        alphas.append(alpha)
        u1s.append(u1)
        ys.append(y)

    c_full = torch.cat([d2, zero, zero], dim=0)  # c_i (0 beyond T-2)
    x1 = x2 = zero[0]
    xs = [None] * t
    for i in range(t - 1, -1, -1):
        x = (ys[i] - u1s[i] * x1 - c_full[i] * x2) / alphas[i]
        xs[i] = x
        x1, x2 = x, x1
    return torch.stack(xs, dim=0)


__all__ = ["banded_matvec", "banded_solve_scan"]
