"""Symmetric-positive-definite fast path: Cholesky solve, inverse and
log-determinant (counterpart of ``linalg_solver_tpu.ops.spd``).

When a batch is known SPD (Gram matrices, normal equations,
covariances), Cholesky halves the work of LU, needs no pivoting, and its
failure is the definiteness test, reported as a per-lane ``ok`` flag
rather than a wrong answer.

``jnp.linalg.cholesky`` returns a NaN factor for a matrix that is not
positive definite; ``torch.linalg.cholesky_ex`` returns finite garbage
and a nonzero ``info`` there (``torch.linalg.cholesky`` raises, and on
the card waits for the host to check).  ``cholesky_or_nan`` sets the
lower triangle of such a lane's factor to NaN, as the reference's is, so
every ``ok = isfinite(...)`` flag built on it (here, in ``ops.lstsq``,
``ops.svd`` and ``ops.orth``) is False in the same lanes as the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .kernels.gauss_jordan import _first_argmax


def cholesky_or_nan(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.cholesky``: the lower Cholesky factor of ``(x + xᵀ)/2``
    for every ``[n, n]`` matrix of ``x [B, n, n]``; where a matrix is not
    positive definite, NaN throughout its lower triangle (the upper one
    stays zero)."""
    L, info = torch.linalg.cholesky_ex((x + x.transpose(1, 2)) / 2)
    n = x.shape[-1]
    lower = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    return torch.where((info != 0)[:, None, None] & lower, torch.nan, L)


class CholeskyResult(NamedTuple):
    L: torch.Tensor   # [B, n, n] lower factor (a = L Lᵀ); NaN lower
    #                   triangle where not positive definite
    ok: torch.Tensor  # [B] matrix was SPD (factor finite)


class _Cholesky(torch.autograd.Function):
    """Cholesky of ``(a + aᵀ)/2`` with Murray's adjoint
    ``Ā = sym(L⁻ᵀ Φ(Lᵀ L̄) L⁻¹)``, ``Φ`` the lower triangle with the
    diagonal halved: two triangular solves, no refactorization."""

    @staticmethod
    def forward(ctx, a):
        L = cholesky_or_nan(0.5 * (a + a.transpose(1, 2)))
        ctx.save_for_backward(L)
        return L

    @staticmethod
    @f32_matmuls()
    def backward(ctx, gL):
        (L,) = ctx.saved_tensors
        n = L.shape[-1]
        Lt = L.transpose(1, 2)
        P = Lt @ gL
        phi = torch.tril(P) - 0.5 * P * torch.eye(n, dtype=L.dtype,
                                                  device=L.device)
        # S = L⁻ᵀ Φ L⁻¹:  X = L⁻ᵀ Φ, then S = (L⁻ᵀ Xᵀ)ᵀ
        X = torch.linalg.solve_triangular(Lt, phi, upper=True)
        S = torch.linalg.solve_triangular(
            Lt, X.transpose(1, 2), upper=True).transpose(1, 2)
        return 0.5 * (S + S.transpose(1, 2))


def cholesky_batched(a: torch.Tensor) -> CholeskyResult:
    """Cholesky factor of a batched SPD matrix (symmetrized first).
    Differentiable through ``_Cholesky``'s adjoint, the reference's."""
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    L = _Cholesky.apply(a)
    return CholeskyResult(L, torch.isfinite(L).all(dim=(1, 2)))


def _spd_solve(L: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """``(L Lᵀ)⁻¹ b3`` by two triangular solves."""
    y = torch.linalg.solve_triangular(L, b3, upper=False)
    return torch.linalg.solve_triangular(L.transpose(1, 2), y, upper=True)


@f32_matmuls()
def cholesky_solve_batched(a: torch.Tensor, b: torch.Tensor):
    """Solve SPD systems ``a x = b`` (``b [B, n]`` or ``[B, n, k]``).
    Returns ``(x, ok)``; non-SPD lanes carry NaNs and ``ok=False``."""
    res = cholesky_batched(a)
    vector_input = b.dim() == 2
    b3 = (b[:, :, None] if vector_input else b).to(res.L.dtype)
    x = _spd_solve(res.L, b3)
    return (x[:, :, 0] if vector_input else x), res.ok


@f32_matmuls()
def cholesky_inverse_batched(a: torch.Tensor):
    """Inverse of a batched SPD matrix: two triangular solves against the
    identity.  Returns ``(inv, ok)``."""
    res = cholesky_batched(a)
    eye = torch.eye(a.shape[-1], dtype=res.L.dtype,
                    device=a.device).expand_as(res.L)
    return _spd_solve(res.L, eye), res.ok


def logdet_spd_batched(a: torch.Tensor):
    """Sign-free log-determinant of SPD batches, ``2·Σ log diag(L)``:
    free of the overflow ``det`` itself would meet outside the float32
    range.  Returns ``(logdet, ok)``."""
    res = cholesky_batched(a)
    d = res.L.diagonal(dim1=1, dim2=2)
    return 2.0 * torch.log(torch.clamp(d, min=1e-38)).sum(dim=1), res.ok


class PivotedCholesky(NamedTuple):
    """Rank-revealing ``A ≈ L Lᵀ`` with ``L [B, n, r]`` built greedily on
    the largest remaining diagonal (LAPACK pstrf's pivot rule).
    ``piv[b, :rank[b]]`` are the chosen pivots in order; columns ≥ rank
    are exactly zero.  ``resid_diag`` is the trace of the unfactored
    remainder (the Nyström trace error ``‖A − L Lᵀ‖_tr``)."""

    L: torch.Tensor           # [B, n, r]
    piv: torch.Tensor         # [B, r] int32
    rank: torch.Tensor        # [B] int32
    resid_diag: torch.Tensor  # [B]
    ok: torch.Tensor          # [B] no negative remaining diagonal beyond
    #                           roundoff was hit (input numerically PSD)


@f32_matmuls()
def pivoted_cholesky_batched(
    a: torch.Tensor,
    max_rank: int = 0,
    rtol: float = 0.0,
) -> PivotedCholesky:
    """Batched diagonal-pivoted Cholesky of PSD matrices: the
    rank-revealing, low-rank form (``pstrf`` semantics, early stop at
    ``max_rank`` for Nyström-style kernel approximation).

    Each of the ``r`` steps picks the largest remaining diagonal of each
    lane (the first index of a tie, as ``jnp.argmax``), forms the
    Schur-complement column against the columns built so far, normalizes
    it and downdates the diagonal.  A lane stops when its remaining
    diagonal falls below ``rtol · trace(A)`` (default ``n·eps``, the PSD
    roundoff floor) and freezes; ``rank`` is where it stopped.  The steps
    are a Python loop of batched operations with no host read."""
    f32 = torch.promote_types(a.dtype, torch.float32)
    a = a.to(f32)
    a = 0.5 * (a + a.transpose(1, 2))
    bsz, n, _ = a.shape
    r = n if max_rank == 0 else min(max_rank, n)
    eps = torch.finfo(f32).eps
    if rtol == 0.0:
        rtol = n * eps

    dev = a.device
    D = a.diagonal(dim1=1, dim2=2).clone()
    trace0 = torch.clamp(D.sum(dim=1), min=1e-30)
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(bsz, device=dev)
    L = torch.zeros(bsz, n, r, dtype=f32, device=dev)
    piv = torch.zeros(bsz, r, dtype=torch.int32, device=dev)
    rank = torch.zeros(bsz, dtype=torch.int32, device=dev)
    ok = torch.ones(bsz, dtype=torch.bool, device=dev)
    for j in range(r):
        # used pivots carry -inf
        p = _first_argmax(D)
        d = D[lanes, p]
        active = (d > rtol * trace0) & (rank == j)
        oh = rows[None, :] == p[:, None]
        col = a[lanes, :, p] - (L @ L[lanes, p, :, None])[:, :, 0]
        d_safe = torch.sqrt(torch.clamp(d, min=1e-30))
        newcol = torch.where(active[:, None], col / d_safe[:, None], 0.0)
        # the pivot row of the new column is exactly sqrt(d); rows of
        # pivots already used are eliminated exactly in exact arithmetic
        used = D == -torch.inf
        newcol = torch.where(used, 0.0, newcol)
        newcol = torch.where(
            oh, torch.where(active, d_safe, 0.0)[:, None], newcol)
        L[:, :, j] = newcol
        D = D - newcol * newcol
        ok = ok & (torch.where(used, 0.0, D).amin(dim=1)
                   > -64.0 * n * eps * trace0)
        D = torch.where(oh & active[:, None], -torch.inf, D)
        piv[:, j] = p.to(torch.int32)
        rank = torch.where(active, j + 1, rank)
    resid = torch.where(D == -torch.inf, 0.0, torch.clamp(D, min=0.0)).sum(
        dim=1)
    return PivotedCholesky(L, piv, rank, resid, ok)
