"""Batched polynomial eigenproblems ``(Σ_i λ^i A_i) v = 0`` (counterpart
of ``linalg_solver_tpu.ops.quadeig``).

``polyeig_batched`` solves matrix polynomials of any degree d by the
first companion linearization to a dn×dn generalized pencil

    A z = λ B z,
    A = [[0, I, 0, …], …, [−A₀, −A₁, …, −A_{d−1}]],
    B = blockdiag(I, …, I, A_d),
    z = [v; λv; λ²v; …; λ^{d−1}v],

handed to the shift-invert pencil solver (``ops.geig``), which makes a
singular leading coefficient A_d legal: each rank deficiency of A_d
shows as a flagged infinite eigenvalue of the pencil.  The polynomial
eigenvectors are the top block of z.  ``quadeig_batched`` is the
degree-2 entry point (``λ²M + λC + K``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..utils.precision import f32_matmuls
from .geig import eig_generalized_shifted_batched


class PolyEigResult(NamedTuple):
    """d·n eigenvalues a lane (``finite=False`` columns are the infinite
    eigenvalues a singular leading coefficient induces).  ``vectors_*``
    hold the polynomial eigenvectors v (top block of the companion
    vector), unit-normalized; ``resid`` is the true relative residual
    ``‖(Σ λ^i A_i)v‖ / Σ |λ|^i‖A_i‖₁`` for finite λ."""

    real: torch.Tensor          # [B, d·n]
    imag: torch.Tensor          # [B, d·n]
    vectors_real: torch.Tensor  # [B, n, d·n]
    vectors_imag: torch.Tensor  # [B, n, d·n]
    finite: torch.Tensor        # [B, d·n]
    valid: torch.Tensor         # [B, d·n]
    ok: torch.Tensor            # [B]
    resid: torch.Tensor         # [B, d·n]


# the degree-2 result keeps its historical name (same fields)
QuadEigResult = PolyEigResult


def polyeig_batched(coeffs: Sequence[torch.Tensor],
                    sigma: Optional[float] = None) -> PolyEigResult:
    """Solve batched matrix-polynomial pencils ``Σ_i λ^i A_i``.

    ``coeffs = [A₀, A₁, …, A_d]`` (lowest degree first, each
    ``[B, n, n]``, d ≥ 1).  The leading coefficient may be singular (the
    regular-pencil requirement moves to ``det(Σ λ^i A_i) ≢ 0``)."""
    if len(coeffs) < 2:
        raise ValueError(
            "polyeig needs at least [A0, A1] (degree >= 1); "
            f"got {len(coeffs)} coefficient(s).")
    f32 = torch.promote_types(coeffs[0].dtype, torch.float32)
    coeffs = [c.to(f32) for c in coeffs]
    d = len(coeffs) - 1
    B, n, _ = coeffs[0].shape
    dev = coeffs[0].device
    eye = torch.eye(n, dtype=f32, device=dev).expand(B, n, n)
    zero = torch.zeros(B, n, n, dtype=f32, device=dev)

    rows = [torch.cat([eye if j == i + 1 else zero for j in range(d)], 2)
            for i in range(d - 1)]
    last = torch.cat([-c for c in coeffs[:d]], 2)
    A = torch.cat(rows + [last], 1)
    Bm = torch.cat([
        torch.cat([(coeffs[d] if i == d - 1 else eye) if j == i else zero
                   for j in range(d)], 2)
        for i in range(d)], 1)
    res = eig_generalized_shifted_batched(A, Bm, sigma=sigma)
    Vr = res.vectors_real[:, :n, :]
    Vi = res.vectors_imag[:, :n, :]
    nrm = torch.sqrt((Vr * Vr + Vi * Vi).sum(1)).clamp(min=1e-30)[:, None, :]
    Vr, Vi = Vr / nrm, Vi / nrm

    # the true polynomial residual of the finite columns, in re/im
    # arithmetic: λ^i by the complex-power recurrence, each A_i applied
    lr = torch.where(res.finite, res.real, 0.0)
    li = torch.where(res.finite, res.imag, 0.0)
    lam_abs = torch.hypot(lr, li)
    pr, pi = torch.ones_like(lr), torch.zeros_like(lr)      # λ⁰
    pow_abs = torch.ones_like(lam_abs)
    rr, ri = torch.zeros_like(Vr), torch.zeros_like(Vi)
    scale = torch.zeros_like(lam_abs)
    with f32_matmuls():
        for i, Ai in enumerate(coeffs):
            Ar, Aim = Ai @ Vr, Ai @ Vi
            rr = rr + pr[:, None, :] * Ar - pi[:, None, :] * Aim
            ri = ri + pr[:, None, :] * Aim + pi[:, None, :] * Ar
            scale = scale + pow_abs * Ai.abs().sum(1).amax(1)[:, None]
            if i < d:
                pr, pi = pr * lr - pi * li, pr * li + pi * lr
                pow_abs = pow_abs * lam_abs
    resid = torch.sqrt((rr * rr + ri * ri).sum(1)) / scale.clamp(min=1e-30)
    resid = torch.where(res.finite, resid, 0.0)
    return PolyEigResult(res.real, res.imag, Vr, Vi, res.finite, res.valid,
                         res.ok, resid)


def quadeig_batched(m: torch.Tensor, c: torch.Tensor, k: torch.Tensor,
                    sigma: Optional[float] = None) -> QuadEigResult:
    """Solve batched quadratic pencils ``(λ²M + λC + K) v = 0``; M may be
    singular (its rank deficiencies become flagged infinite eigenvalues).
    The degree-2 entry point of :func:`polyeig_batched`."""
    return polyeig_batched([k, c, m], sigma=sigma)
