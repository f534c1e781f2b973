"""Batched generalized eigenproblems ``A v = λ B v`` (counterpart of
``linalg_solver_tpu.ops.geig``).

Three paths (the full QZ iteration is not implemented; lanes where these
reductions cannot be trusted are flagged, not silently wrong):

- ``eigh_generalized_batched``: symmetric A, SPD B.  Cholesky
  ``B = L Lᵀ``, the standard symmetric problem ``(L⁻¹ A L⁻ᵀ) y = λ y``
  (``ops.symmetric``), then ``v = L⁻ᵀ y``, B-orthonormal (``vᵀ B v = I``).
- ``eig_generalized_batched``: general A, invertible B.  ``B⁻¹A`` on the
  LU factors of ``ops.lu``, then ``ops.schur.eig_batched``; the error
  scales with κ(B), estimated from the same factors and reported.
- ``eig_generalized_shifted_batched``: general A, B allowed singular
  (regular pencils), by the shift-invert transformation
  ``M = (A − σB)⁻¹ B``, whose eigenpairs ``(μ, v)`` map to the pencil's
  by ``λ = σ + 1/μ`` with the same right vectors; ``μ ≈ 0`` marks the
  infinite eigenvalues a singular B induces.  It needs some σ with
  ``A − σB`` invertible, tried over a fixed ladder of shifts; the host
  reads which lanes need the next shift once a try, as the reference
  does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls
from .cond import _inv_onenorm_est
from .lu import lu_factor_batched, lu_solve_batched
from .schur import _f32, eig_batched
from .spd import cholesky_batched
from .symmetric import eigh_batched


class GeneralizedEighResult(NamedTuple):
    w: torch.Tensor   # [B, n] ascending eigenvalues
    V: torch.Tensor   # [B, n, n] B-orthonormal eigenvectors (VᵀBV = I)
    ok: torch.Tensor  # [B] B was SPD (Cholesky finite)


@f32_matmuls()
def eigh_generalized_batched(a: torch.Tensor,
                             b: torch.Tensor) -> GeneralizedEighResult:
    """Solve ``A v = λ B v`` for symmetric A and SPD B a lane.  A lane
    whose B is not SPD gets NaN eigenpairs and ``ok=False``."""
    a = _f32(a)
    chol = cholesky_batched(b)
    L = chol.L
    a_sym = 0.5 * (a + a.transpose(1, 2))
    # C = L⁻¹ A L⁻ᵀ (two batched triangular solves)
    C = torch.linalg.solve_triangular(L, a_sym, upper=False)
    C = torch.linalg.solve_triangular(L, C.transpose(1, 2), upper=False)
    # the library's eigh raises on NaN, where the reference's returns NaN
    finite = torch.isfinite(C).all(dim=(1, 2))
    r = eigh_batched(torch.where(finite[:, None, None], C, 0.0))
    # v = L⁻ᵀ y
    V = torch.linalg.solve_triangular(L.transpose(1, 2), r.V, upper=True)
    w = torch.where(finite[:, None], r.w, torch.nan)
    V = torch.where(finite[:, None, None], V, torch.nan)
    return GeneralizedEighResult(w, V, chol.ok)


class GeneralizedEigResult(NamedTuple):
    real: torch.Tensor          # [B, n]
    imag: torch.Tensor          # [B, n]
    vectors_real: torch.Tensor  # [B, n, n]
    vectors_imag: torch.Tensor  # [B, n, n]
    valid: torch.Tensor         # [B, n]
    ok: torch.Tensor            # [B] B invertible + eigensolve converged
    rcond_b: torch.Tensor       # [B] reciprocal condition estimate of B:
    #                             the eigenvalue error scales with 1/rcond_b


def _rcond_on(res, m: torch.Tensor) -> torch.Tensor:
    """1/κ₁ of the factored ``m`` from its own factors (Hager's estimate,
    no second LU), 0 where the LU met a zero pivot."""
    onenorm = m.abs().sum(1).amax(1)
    inv_est = _inv_onenorm_est(res, 5)
    return torch.where(res.ok, 1.0 / (onenorm * inv_est).clamp(min=1e-30),
                       0.0)


def eig_generalized_batched(a: torch.Tensor,
                            b: torch.Tensor) -> GeneralizedEigResult:
    """Solve ``A v = λ B v`` for general square A and invertible B."""
    a, b = _f32(a), _f32(b)
    res = lu_factor_batched(b)
    m = lu_solve_batched(res, a)          # B⁻¹ A
    eg = eig_batched(m)
    with f32_matmuls():
        rc = _rcond_on(res, b)
    ok = res.ok & eg.converged & (rc > 0)
    return GeneralizedEigResult(eg.real, eg.imag, eg.vectors_real,
                                eg.vectors_imag, eg.valid, ok, rc)


class GeneralizedEigShifted(NamedTuple):
    """Pencil eigenpairs by shift-invert.  ``finite=False`` columns are
    the pencil's infinite eigenvalues (B-nullspace directions; their
    (real, imag) is (+inf, 0)).  ``sigma`` is the shift a lane accepted;
    ``rcond_shift`` the reciprocal condition estimate of ``A − σB``
    (the accuracy scales with 1/rcond_shift)."""

    real: torch.Tensor          # [B, n]
    imag: torch.Tensor          # [B, n]
    vectors_real: torch.Tensor  # [B, n, n]
    vectors_imag: torch.Tensor  # [B, n, n]
    finite: torch.Tensor        # [B, n]
    valid: torch.Tensor         # [B, n]
    ok: torch.Tensor            # [B]
    sigma: torch.Tensor         # [B]
    rcond_shift: torch.Tensor   # [B]


@f32_matmuls()
def _shifted_core(a, b, sigma):
    shifted = a - sigma[:, None, None] * b
    res = lu_factor_batched(shifted)
    m = lu_solve_batched(res, b)          # (A − σB)⁻¹ B
    rc = _rcond_on(res, shifted)
    norm_m = m.abs().sum(1).amax(1)
    return m, res.ok, rc, norm_m


def eig_generalized_shifted_batched(
    a: torch.Tensor, b: torch.Tensor, sigma: Optional[float] = None,
    mu_floor: float = 100.0, rcond_min: float = 1e-5,
) -> GeneralizedEigShifted:
    """Solve the regular pencil ``A v = λ B v`` with B possibly singular,
    by the shift-invert transformation.

    ``(A − σB)⁻¹ B v = μ v  ⇔  A v = (σ + 1/μ) B v``: the standard
    eigenproblem of ``M`` gives the pencil's eigenvectors directly and its
    eigenvalues through ``λ = σ + 1/μ``; ``|μ|`` at the μ-noise floor
    (below ``mu_floor·n·eps·‖M‖₁``: a true infinite eigenvalue computes to
    μ = O(eps·‖M‖), a scale that does not shrink when σ sits close to an
    eigenvalue) marks an infinite pencil eigenvalue.  With
    ``sigma=None`` a fixed ladder of shifts scaled by ``‖A‖₁/‖B‖₁`` is
    tried and each lane keeps the first whose ``A − σB`` is comfortably
    invertible (rcond ≥ rcond_min); for a regular pencil almost every σ
    works, so the first try nearly always lands."""
    a, b = _f32(a), _f32(b)
    Bn, n = a.shape[0], a.shape[1]
    norm_a = a.abs().sum(1).amax(1)
    norm_b = b.abs().sum(1).amax(1)
    rho = norm_a.clamp(min=1e-30) / norm_b.clamp(min=1e-30)
    if sigma is not None:
        ladder = [torch.full((Bn,), sigma, dtype=a.dtype, device=a.device)]
    else:
        # irrational multipliers: a σ that hits an eigenvalue exactly is
        # measure-zero, and these avoid the common integer spectra
        ladder = [c * rho for c in (1.077351, -0.538674, 3.912023, 0.276393)]

    sig = ladder[0]
    m, okf, rc, norm_m = _shifted_core(a, b, sig)
    for cand in ladder[1:]:
        bad = (~okf) | (rc < rcond_min)
        if not bool(bad.any()):          # the host's one read a try
            break
        sig = torch.where(bad, cand, sig)
        m2, ok2, rc2, nm2 = _shifted_core(a, b, sig)
        m = torch.where(bad[:, None, None], m2, m)
        okf = torch.where(bad, ok2, okf)
        rc = torch.where(bad, rc2, rc)
        norm_m = torch.where(bad, nm2, norm_m)

    eg = eig_batched(m)
    mu_re, mu_im = eg.real, eg.imag
    mu2 = mu_re * mu_re + mu_im * mu_im
    eps = torch.finfo(a.dtype).eps
    finite = torch.sqrt(mu2) > (mu_floor * n * eps) * norm_m[:, None]
    inv_den = mu2.clamp(min=1e-38)
    lam_re = torch.where(finite, sig[:, None] + mu_re / inv_den, torch.inf)
    lam_im = torch.where(finite, -mu_im / inv_den, 0.0)
    ok = okf & eg.converged & (rc >= rcond_min)
    return GeneralizedEigShifted(lam_re, lam_im, eg.vectors_real,
                                 eg.vectors_imag, finite, eg.valid, ok, sig,
                                 rc)
