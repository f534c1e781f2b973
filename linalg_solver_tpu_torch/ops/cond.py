"""Batched condition-number estimation, 1-norm, Hager/Higham
(counterpart of ``linalg_solver_tpu.ops.cond``).

``cond1_est_batched`` estimates κ₁(A) = ‖A‖₁·‖A⁻¹‖₁ from one LU
factorization (``ops.lu.lu_factor_batched``, the reference's pivots):
‖A⁻¹‖₁ by Hager's power method on the dual norm (LAPACK dlacon's core),
which needs only solves with A and Aᵀ on the same packed L\\U.  The
estimate is a lower bound on the true norm, in practice within a small
factor of it (usually exact for random matrices), the contract of
LAPACK's ``rcond``.

The reference substitutes one row at a time in ``fori_loop``s, outside
any Pallas kernel; the port solves the packed factors' triangles with
``torch.linalg.solve_triangular``, one call a triangle, which rounds
within the same bound (a rcond call at n = 256 would otherwise be about
11 × 512 row steps).
"""

from __future__ import annotations

import torch

from ..utils.precision import f32_matmuls
from .kernels.gauss_jordan import _first_argmax
from .lu import LUResult, lu_factor_batched


def _as_columns(lu: torch.Tensor, b: torch.Tensor):
    vector_input = b.dim() == lu.dim() - 1
    return (b[..., None] if vector_input else b).to(lu.dtype), vector_input


def _lu_solve(res: LUResult, b: torch.Tensor) -> torch.Tensor:
    """``a x = b`` for every system given ``lu_factor_batched(a)``: the
    unit-lower triangle, then the upper one."""
    lu = res.lu
    b3, vector_input = _as_columns(lu, b)
    pb = torch.take_along_dim(b3, res.perm.long()[:, :, None], dim=1)
    y = torch.linalg.solve_triangular(lu, pb, upper=False,
                                      unitriangular=True)
    x = torch.linalg.solve_triangular(lu, y, upper=True)
    return x[..., 0] if vector_input else x


@f32_matmuls()
def lu_solve_transposed_batched(res: LUResult, b: torch.Tensor) -> torch.Tensor:
    """Solve ``aᵀ x = b`` for every system given ``lu_factor_batched(a)``
    (``b [B, n]`` or ``[B, n, k]``).

    With ``P a = L U`` (row i of Pa is row perm[i] of a),
    ``aᵀ = Uᵀ Lᵀ P``: solve the lower-triangular ``Uᵀ``, then the
    unit-upper ``Lᵀ``, then un-permute (``x[perm] = v``)."""
    lut = res.lu.transpose(-1, -2)
    b3, vector_input = _as_columns(res.lu, b)
    w = torch.linalg.solve_triangular(lut, b3, upper=False)
    v = torch.linalg.solve_triangular(lut, w, upper=True, unitriangular=True)
    x = torch.empty_like(v).scatter_(
        1, res.perm.long()[:, :, None].expand_as(v), v)
    return x[..., 0] if vector_input else x


def lu_solve_transposed(res: LUResult, b: torch.Tensor) -> torch.Tensor:
    """Solve ``aᵀ x = b`` given ``lu_factor(a)`` (a single system)."""
    return lu_solve_transposed_batched(
        LUResult(*(t[None] for t in res)), b[None])[0]


def _inv_onenorm_est(res: LUResult, iters: int) -> torch.Tensor:
    """Hager's estimate of ‖A⁻¹‖₁ for every factorization of the batch.

    A fixed number of iterations: a converged one re-selects the same unit
    vector and leaves the running maximum unchanged, so there is no early
    exit.  Then dlacn2's alternating-sign probe as a second lower bound
    (it catches the counterexamples where the power method stalls)."""
    lu = res.lu
    bsz, n = lu.shape[0], lu.shape[-1]
    dt, dev = lu.dtype, lu.device
    rows = torch.arange(n, device=dev)
    x = torch.full((bsz, n), 1.0 / n, dtype=dt, device=dev)
    est = torch.zeros(bsz, dtype=dt, device=dev)
    for _ in range(iters):
        y = _lu_solve(res, x)
        est = torch.maximum(est, y.abs().sum(dim=1))
        xi = torch.where(y >= 0, 1.0, -1.0).to(dt)
        j = _first_argmax(lu_solve_transposed_batched(res, xi).abs())
        x = (rows[None, :] == j[:, None]).to(dt)
    # x̃ᵢ = (−1)ⁱ·(1 + i/(n−1)):  ‖A⁻¹‖₁ ≥ 2‖A⁻¹x̃‖₁/(3n)
    alt = torch.where(rows % 2 == 0, 1.0, -1.0) * (
        1.0 + rows.to(dt) / max(n - 1, 1))
    y_alt = _lu_solve(res, alt.to(dt).expand(bsz, n))
    return torch.maximum(est, 2.0 * y_alt.abs().sum(dim=1) / (3.0 * n))


@f32_matmuls()
def cond1_est_batched(a: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """[B] estimate of κ₁ = ‖A‖₁·‖A⁻¹‖₁ per lane (inf for singular): a
    lower bound within a small factor of the truth, LAPACK's contract.
    Use it to gate solves (κ·eps ≳ 1 leaves no trusted digit)."""
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    onenorm = a.abs().sum(dim=1).amax(dim=1)
    res = lu_factor_batched(a)
    kappa = onenorm * _inv_onenorm_est(res, iters)
    return torch.where(res.ok, kappa, torch.inf)


def rcond_batched(a: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """[B] reciprocal condition estimate 1/κ₁ (0 for singular), LAPACK's
    ``rcond`` convention: compare it with ``eps`` to see how many digits
    of a solve survive."""
    kappa = cond1_est_batched(a, iters=iters)
    return torch.where(torch.isfinite(kappa), 1.0 / kappa, 0.0)
