"""Pivot-free batched inverse by log-depth Schur recursion (counterpart of
``linalg_solver_tpu.ops.lu_recursive``).

    A = [[A11, A12],          A⁻¹ = [[iA11 + P iS Q, −P iS],
         [A21, A22]]                 [−iS Q,          iS   ]]

with ``P = iA11 A12``, ``Q = A21 iA11`` and the Schur complement ``S =
A22 − A21 P``: five batched products a node, two recursive calls, down to
a ``leaf``-sized unrolled Gauss–Jordan.  Only stable where every leading
principal minor is well conditioned; the caller makes that so with
random butterflies (``ops.lu_large.large_solve_rbt``) and gates each
system on its residual.  The products run at the caller's matmul
precision.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _leaf_inverse(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-pivot Gauss–Jordan inverse of ``[B, k, k]``, one elementwise
    pass over ``[A | I]`` a column.  Returns ``(inv, ok)``; ``ok [B]`` is
    False where a diagonal pivot was exactly zero."""
    B, k, _ = a.shape
    eye = torch.eye(k, dtype=a.dtype, device=a.device).expand(B, k, k)
    w = torch.cat([a, eye], dim=-1)                     # [B, k, 2k]
    rows = torch.arange(k, device=a.device)[None, :, None]
    ok = torch.ones(B, dtype=torch.bool, device=a.device)
    for c in range(k):
        pv = w[:, c, c]
        has = pv.abs() > 0.0
        ok = ok & has
        inv = 1.0 / torch.where(has, pv, torch.ones_like(pv))
        prow = w[:, c, :] * inv[:, None]                # [B, 2k]
        f = torch.where(rows[:, :, 0] == c, 0.0, w[:, :, c])
        w = w - f[:, :, None] * prow[:, None, :]
        w = torch.where(rows == c, prow[:, None, :], w)
    return w[:, :, k:], ok


def _inv_rec(a: torch.Tensor, leaf: int):
    n = a.shape[-1]
    if n <= leaf:
        return _leaf_inverse(a)
    h = n // 2
    a11, a12 = a[:, :h, :h], a[:, :h, h:]
    a21, a22 = a[:, h:, :h], a[:, h:, h:]
    ia11, ok1 = _inv_rec(a11, leaf)
    p = ia11 @ a12
    q = a21 @ ia11
    is_, ok2 = _inv_rec(a22 - a21 @ p, leaf)
    bl = -(is_ @ q)
    tr = -(p @ is_)
    tl = ia11 - p @ bl
    top = torch.cat([tl, tr], dim=-1)
    bot = torch.cat([bl, is_], dim=-1)
    return torch.cat([top, bot], dim=-2), ok1 & ok2


def inverse_nopivot_recursive(
    a: torch.Tensor, leaf: int = 16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched inverse of ``a [B, n, n]`` without pivoting, by Schur
    recursion down to ``leaf``.  Returns ``(inv, ok)`` with ``ok [B]``
    False where a leaf pivot was exactly zero."""
    if a.dim() != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"a must be [B, n, n]; got {tuple(a.shape)}")
    if leaf < 1:
        raise ValueError(f"leaf must be >= 1, got {leaf}")
    return _inv_rec(a, leaf)
