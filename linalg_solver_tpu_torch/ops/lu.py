"""Batched LU factorization with partial pivoting, the loop form
(counterpart of ``linalg_solver_tpu.ops.lu``).

Right-looking LU whose column steps are a Python loop, each step one
batched tensor operation over ``[B, n, n]`` with explicit row swaps, the
``tol`` pivot rule and the swap sign; the substitutions are loops over
rows, batched.  Step k updates the trailing block only: the reference
also multiplies the rows above and the columns left of it by zero, which
changes nothing but spreads a NaN or an Inf, so on finite input the two
agree to the bit.  ``L`` (unit diagonal, below) and ``U`` (at and above)
are packed into one ``[n, n]`` array.  This is the ``"loop"`` backend of
``ops.dispatch`` and the correctness oracle the blocked paths are held
against.

Determinant = sign × prod(diag U).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .kernels.gauss_jordan import _first_argmax, fms


class LUResult(NamedTuple):
    lu: torch.Tensor     # [..., n, n] packed L\U
    perm: torch.Tensor   # [..., n] int32: row i of PA is row perm[i] of A
    sign: torch.Tensor   # [...] ±1 (det of P)
    ok: torch.Tensor     # [...] bool: no zero pivot encountered


def lu_factor_batched(a: torch.Tensor, tol: float = 0.0) -> LUResult:
    """Factor every ``[n, n]`` matrix of ``a [B, n, n]``: ``P a = L U``.
    Step k takes the first row of largest ``|A[k:, k]|``; a column whose
    best candidate is not above ``tol`` keeps its rows and marks the
    matrix not ``ok``."""
    bsz, n, _ = a.shape
    A = a.to(torch.promote_types(a.dtype, torch.float32), copy=True)
    dt, dev = A.dtype, A.device
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(bsz, device=dev)
    perm = rows.to(torch.int32).expand(bsz, n).clone()
    sign = torch.ones(bsz, dtype=dt, device=dev)
    ok = torch.ones(bsz, dtype=torch.bool, device=dev)
    for k in range(n):
        masked = torch.where(rows[None, :] >= k, A[:, :, k].abs(), -torch.inf)
        p = _first_argmax(masked)
        has = masked[lanes, p] > tol
        do_swap = has & (p != k)
        for t in (A, perm):
            row_k, row_p = t[:, k].clone(), t[lanes, p].clone()
            sw = do_swap.view(-1, *([1] * (row_k.dim() - 1)))
            t[:, k] = torch.where(sw, row_p, row_k)
            t[lanes, p] = torch.where(sw, row_k, row_p)
        sign = torch.where(do_swap, -sign, sign)

        factors = (A[:, k + 1:, k]
                   / torch.where(has, A[:, k, k], 1.0)[:, None]
                   * has.to(dt)[:, None])
        # the trailing update; column k keeps the multipliers
        A[:, k + 1:, k + 1:] = fms(A[:, k + 1:, k + 1:], factors[:, :, None],
                                   A[:, k, None, k + 1:])
        A[:, k + 1:, k] = factors
        ok = ok & has
    return LUResult(A, perm, sign, ok)


def lu_factor(a: torch.Tensor, tol: float = 0.0) -> LUResult:
    """Factor a single ``[n, n]`` matrix."""
    return LUResult(*(t[0] for t in lu_factor_batched(a[None], tol)))


@f32_matmuls()
def lu_solve_batched(res: LUResult, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` for every system given ``lu_factor_batched(a)``;
    ``b`` is ``[B, n]`` or ``[B, n, k]``.  Forward substitution with the
    unit-lower factor, then back substitution, one row at a time."""
    lu, perm = res.lu, res.perm
    n = lu.shape[-1]
    vector_input = b.dim() == lu.dim() - 1
    b3 = (b[..., None] if vector_input else b).to(lu.dtype)
    pb = torch.take_along_dim(b3, perm.long()[:, :, None], dim=1)
    rows = torch.arange(n, device=lu.device)
    y = torch.zeros_like(pb)
    for i in range(n):
        li = torch.where(rows < i, lu[:, i, :], 0.0)
        y[:, i] = pb[:, i] - (li[:, None, :] @ y)[:, 0]
    x = torch.zeros_like(pb)
    for i in reversed(range(n)):
        ui = torch.where(rows > i, lu[:, i, :], 0.0)
        x[:, i] = (y[:, i] - (ui[:, None, :] @ x)[:, 0]) / lu[:, i, i, None]
    return x[..., 0] if vector_input else x


def lu_solve(res: LUResult, b: torch.Tensor) -> torch.Tensor:
    """Solve a single system given ``lu_factor(a)``; ``b`` is ``[n]`` or
    ``[n, k]``."""
    return lu_solve_batched(LUResult(*(t[None] for t in res)), b[None])[0]


def det_lu_batched(a: torch.Tensor) -> torch.Tensor:
    """Determinants via LU: sign × product of U's diagonal, 0 where a
    column had no pivot."""
    res = lu_factor_batched(a)
    d = res.sign * torch.diagonal(res.lu, dim1=-2, dim2=-1).prod(dim=-1)
    return torch.where(res.ok, d, torch.zeros_like(d))


def det_lu(a: torch.Tensor) -> torch.Tensor:
    return det_lu_batched(a[None])[0]


def solve_lu_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unique-solution solves via LU with partial pivoting.  For singular
    or rectangular systems use ``ops.solve.solve_batched`` (affine
    solution sets)."""
    return lu_solve_batched(lu_factor_batched(a), b)


def solve_lu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return solve_lu_batched(a[None], b[None])[0]
