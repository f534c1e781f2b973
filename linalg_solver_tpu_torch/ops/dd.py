"""f64-class solve, inverse, least squares and eigenvalues (counterpart of
``linalg_solver_tpu.ops.dd``), in native float64.

The reference reaches ~2⁻⁴⁸ relative residuals on a chip without
float64: Ozaki slice GEMMs (bf16 products of 8-bit slices, exact in f32
accumulators) summed into float-float ``(hi, lo)`` pairs.  The H100 has
float64, so here every residual, Rayleigh quotient and Newton–Schulz
residual is a float64 product of the float32 operands.  The float32
factorizations stay where the reference has them, on the port's kernels:
the solve on ``lu_blocked._pallas_lu_phases`` (panel kernel 6) or the LU
loop, the inverse on ``dispatch.inverse_batched`` (kernel 2 or 3), the
least squares on ``lstsq.qr_batched``, the eigenvalues on ``symmetric.
eigh_batched`` and ``schur.real_schur_vectors`` (the Schur kernels).  The
results keep the reference's types: a value ``v`` refined in float64 is
returned as the float32 pair ``hi = f32(v)``, ``lo = f32(v − hi)``.

Not ported, by design (they exist only to emulate float64 in float32):
``two_sum``, ``fast_two_sum``, ``dd_add_f32``, ``dd_add_dd``, ``dd_neg``,
``_two_prod``, ``_dd_recip``, ``_dd_mul_dd``, ``_dot_columns_dd``,
``_pow2_norm``, ``_slice_int8``, ``SlicedMatrix``, ``slice_rows``,
``slice_cols`` and ``matmul_sliced_dd``, nor the slice count ``t`` and
the ``interpret`` flag of the entry points.  ``eig_dd_batched``'s eager
compensated tail (a workaround for XLA:CPU's fused codegen) has no
counterpart either: its quotient is one float64 division.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls

_F32, _F64 = torch.float32, torch.float64


def _split(v: torch.Tensor):
    """``(hi, lo)`` float32 of a float64 ``v``: ``hi = f32(v)``,
    ``lo = f32(v − hi)``."""
    hi = v.to(_F32)
    return hi, (v - hi.to(_F64)).to(_F32)


class DDMatmul(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def matmul_dd_batched(a: torch.Tensor, b: torch.Tensor) -> DDMatmul:
    """``a @ b`` for f32 batches ``[B, m, k] × [B, k, n]``, computed in
    float64 (each product of two float32 numbers is exact there) and
    returned as the ``(hi, lo)`` float32 pair."""
    return DDMatmul(*_split(a.to(_F32).to(_F64) @ b.to(_F32).to(_F64)))


class DDSolveResult(NamedTuple):
    """Refined solve: ``x ≈ x_hi + x_lo``.  ``resid`` is the last
    float64 residual's max-norm per lane (computed before the last
    correction, as the reference computes it); ``ok`` = factorization
    succeeded AND the residual shrank to ≤ 1e-10·scale."""

    x_hi: torch.Tensor
    x_lo: torch.Tensor
    resid: torch.Tensor
    ok: torch.Tensor


def _dd_refine(a, b, x_hi, solve_fn, iters: int):
    """Refinement shared by the solves: the residual ``b − A x`` in
    float64 from the f32 ``A``, ``b`` and ``x = x_hi + x_lo``, the
    correction through the f32 factors (``solve_fn``), until every lane's
    residual is at ``1e-12·max(‖A‖·‖x‖, ‖b‖)`` or ``iters`` rounds (the
    reference's loop; its condition is read on the host a round)."""
    a64, b64 = a.to(_F64), b.to(_F64)
    x = x_hi.to(_F64)
    amax = a.abs().amax(dim=(1, 2))
    bmax = b.abs().amax(dim=1)
    resid = torch.full_like(bmax, torch.inf)

    def target(x_hi):
        return 1e-12 * torch.clamp(
            torch.maximum(amax * x_hi.abs().amax(dim=1), bmax), min=1e-30)

    for _ in range(iters):
        if not bool((resid > target(x.to(_F32))).any()):
            break
        r = (b64 - (a64 @ x[:, :, None])[:, :, 0]).to(_F32)
        x = x + solve_fn(r).to(_F64)
        resid = r.abs().amax(dim=1)
    x_hi, x_lo = _split(x)
    return x_hi, x_lo, resid


def _dd_ok(a, b, x_hi, resid, fac_ok):
    scale = torch.maximum(a.abs().amax(dim=(1, 2)) * x_hi.abs().amax(dim=1),
                          b.abs().amax(dim=1))
    return fac_ok & (resid <= 1e-10 * torch.clamp(scale, min=1e-30))


@f32_matmuls()
def _solve_dd_phases(a, b, iters: int, nb: int) -> DDSolveResult:
    """Phase-factored solve: ONE blocked factorization on panel kernel 6
    (``lu_blocked._pallas_lu_phases``), the corrections through its kept
    blocks (``_phases_solve``)."""
    from .lu_blocked import (_later_masks, _pallas_lu_phases,
                             _phases_backward, _phases_solve)

    n = b.shape[1]
    m = n // nb
    ph = _pallas_lu_phases(a, nb, rhs=b[:, :, None])
    masks = _later_masks(ph, n)
    x_hi = _phases_backward(ph, ph.ys, m, nb)[:, :, 0]
    x_hi, x_lo, resid = _dd_refine(
        a, b, x_hi,
        lambda r: _phases_solve(ph, masks, r[:, :, None], m, nb)[:, :, 0],
        iters)
    return DDSolveResult(x_hi, x_lo, resid, _dd_ok(a, b, x_hi, resid, ph.ok))


@f32_matmuls()
def _solve_dd_loop(a, b, iters: int) -> DDSolveResult:
    """Loop-LU solve (N the blocked panels cannot tile)."""
    from .lu import lu_factor_batched, lu_solve_batched

    fac = lu_factor_batched(a)
    x_hi = lu_solve_batched(fac, b)
    x_hi, x_lo, resid = _dd_refine(
        a, b, x_hi, lambda r: lu_solve_batched(fac, r), iters)
    return DDSolveResult(x_hi, x_lo, resid, _dd_ok(a, b, x_hi, resid,
                                                    fac.ok))


def solve_dd_batched(a: torch.Tensor, b: torch.Tensor, iters: int = 10,
                     nb: Optional[int] = None) -> DDSolveResult:
    """Solve ``A x = b`` (``b`` vectors ``[B, n]``) to f64-CLASS backward
    error: one f32 LU (the blocked phase loop on panel kernel 6 where
    ``nb``, by default the first of 64, 48, 32, 16, 8 dividing N, tiles
    N ≥ 16; else the LU loop) and up to ``iters`` rounds of refinement
    with float64 residuals.  Each round multiplies the error by
    ~κ(A)·2⁻²⁴, so κ ≲ 1e6 converges in a few rounds.  ``A`` and ``b``
    are taken as float32, as the reference takes them."""
    a, b = a.to(_F32), b.to(_F32)
    n = b.shape[1]
    if nb is None:
        nb = next((w for w in (64, 48, 32, 16, 8) if n % w == 0), None)
    if nb is None or n < 16:
        return _solve_dd_loop(a, b, iters)
    return _solve_dd_phases(a, b, iters, min(nb, n))


class DDEighResult(NamedTuple):
    """Refined symmetric eigenvalues: ``w`` (+ ``w_lo``) the float64
    Rayleigh quotient of each column, ``V`` the f32 eigenvectors
    (unrefined), ``resid = ‖A v − w v‖₂`` per column in float64 (for
    symmetric A, ``|w − λ| ≤ resid/‖v‖`` always)."""

    w: torch.Tensor          # [B, n]
    w_lo: torch.Tensor       # [B, n]
    V: torch.Tensor          # [B, n, n]
    resid: torch.Tensor      # [B, n]
    converged: torch.Tensor  # [B]


def eigh_dd_batched(a: torch.Tensor) -> DDEighResult:
    """Symmetric eigenvalues to (near-)f64 accuracy: one f32 ``eigh``,
    then the Rayleigh quotient ``vᵀAv / vᵀv`` in float64 against the
    symmetrized f32 matrix.  Its error is O(resid²/gap): ~1e-11·‖A‖ for
    gaps ≳ 1e-3·‖A‖; clusters degrade toward the f32 floor, visible in
    ``resid``."""
    from .symmetric import eigh_batched

    r = eigh_batched(a)
    a = a.to(_F32)
    sym = ((a + a.transpose(1, 2)) * 0.5).to(_F64)
    V = r.V.to(_F64)
    av = sym @ V
    w = (V * av).sum(dim=1) / (V * V).sum(dim=1)
    resid = torch.sqrt(((av - w[:, None, :] * V) ** 2).sum(dim=1))
    w_hi, w_lo = _split(w)
    return DDEighResult(w_hi, w_lo, r.V, resid.to(_F32), r.converged)


class DDLstsqResult(NamedTuple):
    """Refined least squares; ``gnorm`` = the last float64
    normal-equations residual ‖Aᵀ(b − Ax)‖∞ per lane (zero at the
    minimizer)."""

    x_hi: torch.Tensor
    x_lo: torch.Tensor
    gnorm: torch.Tensor
    ok: torch.Tensor


@f32_matmuls()
def lstsq_dd_batched(a: torch.Tensor, b: torch.Tensor,
                     iters: int = 10) -> DDLstsqResult:
    """Full-rank least squares ``argmin ‖Ax − b‖`` (``a [B, m, n]``, m ≥
    n, ``b [B, m]``) by corrected semi-normal equations (Björck's CSNE):
    one f32 CholeskyQR2 gives R; each round computes ``r = b − A·x`` and
    ``g = Aᵀr`` in float64 and corrects through ``RᵀR d = g``.  Converges
    while κ(A)²·2⁻²⁴ < 1 (κ ≲ 3e3)."""
    from .lstsq import qr_batched

    a, b = a.to(_F32), b.to(_F32)
    qr = qr_batched(a)
    R = qr.R

    def corr(g):
        y = torch.linalg.solve_triangular(R.transpose(1, 2), g[:, :, None],
                                          upper=False)
        return torch.linalg.solve_triangular(R, y, upper=True)[:, :, 0]

    qtb = (qr.Q.transpose(1, 2) @ b[:, :, None])
    x = torch.linalg.solve_triangular(R, qtb, upper=True)[:, :, 0].to(_F64)
    a64, b64 = a.to(_F64), b.to(_F64)
    amax, bmax = a.abs().amax(dim=(1, 2)), b.abs().amax(dim=1)

    def target(x_hi):
        scale = amax * torch.maximum(amax * x_hi.abs().amax(dim=1), bmax)
        return 1e-10 * torch.clamp(scale, min=1e-30)

    gn = torch.full_like(bmax, torch.inf)
    for _ in range(iters):
        if not bool((gn > target(x.to(_F32))).any()):
            break
        r = b64 - (a64 @ x[:, :, None])[:, :, 0]
        g = (a64.transpose(1, 2) @ r[:, :, None])[:, :, 0].to(_F32)
        x = x + corr(g).to(_F64)
        gn = g.abs().amax(dim=1)
    x_hi, x_lo = _split(x)
    return DDLstsqResult(x_hi, x_lo, gn, qr.ok & (gn <= target(x_hi)))


class DDInverseResult(NamedTuple):
    """Refined inverse: ``A⁻¹ ≈ x_hi + x_lo``; ``resid`` = max|I − A·X|
    per lane (the last float64 residual)."""

    x_hi: torch.Tensor
    x_lo: torch.Tensor
    resid: torch.Tensor
    ok: torch.Tensor


@f32_matmuls()
def inverse_dd_batched(a: torch.Tensor, iters: int = 6) -> DDInverseResult:
    """Matrix inverse to f64-class residual: the f32 inverse of
    ``dispatch.inverse_batched`` (kernel 2 or 3 where they reach), then
    Newton–Schulz rounds ``X ← X + X·(I − A·X)`` with the residual in
    float64 and the correction product in f32 (it multiplies a term
    already ≤ 2⁻²⁴ relative).  Quadratic: two rounds take 1e-7 → ~1e-13
    (κ ≲ 1e6); the loop stops once every lane's residual is ≤ 1e-12."""
    from . import dispatch

    a = a.to(_F32)
    n = a.shape[-1]
    x_hi = dispatch.inverse_batched(a)
    x = x_hi.to(_F64)
    a64 = a.to(_F64)
    eye = torch.eye(n, dtype=_F64, device=a.device)
    resid = torch.full(a.shape[:1], torch.inf, dtype=_F32, device=a.device)
    for _ in range(iters):
        if not bool((resid > 1e-12).any()):
            break
        r = (eye - a64 @ x).to(_F32)
        x = x + (x.to(_F32) @ r).to(_F64)
        resid = r.abs().amax(dim=(1, 2))
    x_hi, x_lo = _split(x)
    ok = (resid <= 1e-10) & torch.isfinite(x_hi).all(dim=(1, 2))
    return DDInverseResult(x_hi, x_lo, resid, ok)


class DDEigResult(NamedTuple):
    """Refined GENERAL (non-symmetric) eigenvalues.

    ``lam_re`` / ``lam_im`` (+ their ``*_lo`` words) the refined
    spectrum; ``s`` the reciprocal condition ``|yᴴx|`` of each eigenvalue
    (unit right and left eigenvectors, dgeevx's RCONDE); ``resid`` the
    float64 ``‖Av − λv‖₂`` per column; ``err_bound = resid / s``, the
    first-order bound.  Clustered or defective eigenvalues show up as a
    small ``s`` and a large ``err_bound``."""

    lam_re: torch.Tensor     # [B, n]
    lam_re_lo: torch.Tensor  # [B, n]
    lam_im: torch.Tensor     # [B, n]
    lam_im_lo: torch.Tensor  # [B, n]
    s: torch.Tensor          # [B, n]
    resid: torch.Tensor      # [B, n]
    err_bound: torch.Tensor  # [B, n]
    valid: torch.Tensor      # [B, n] both eigenvectors exist
    converged: torch.Tensor  # [B]


@f32_matmuls()
def _eigvecs_two_sided(T, Q, scale):
    """Unit right and left eigenvectors of ``A = D⁻¹ Q T Qᵀ D`` from its
    real Schur pair, in f32: right ones by ``_trevc_full(T)``, left ones
    by the same back-substitution through the reversal ``J Tᵀ J`` (as
    ``schur.eig_condition_batched``).  Returns ``(Vr, Vi, Wr, Wi, lam0_re,
    lam0_im, valid)``."""
    from .schur import _eigvals_from_T, _trevc_full

    Xr, Xi, valid_r = _trevc_full(T)
    S = T.transpose(1, 2).flip((1, 2))
    Zr, Zi, valid_l = _trevc_full(S)
    Yr, Yi = Zr.flip((1, 2)), Zi.flip((1, 2))
    valid_l = valid_l.flip(1)
    lam0_re, lam0_im = _eigvals_from_T(T)
    lamS_im = _eigvals_from_T(S)[1].flip(1)
    conj_fix = (lamS_im - lam0_im).abs() < (lamS_im + lam0_im).abs()
    Yi = torch.where(conj_fix[:, None, :], -Yi, Yi)

    def back(yr, yi, mul):
        vr = (Q @ yr) * mul[:, :, None]
        vi = (Q @ yi) * mul[:, :, None]
        nrm = torch.clamp(torch.sqrt((vr * vr + vi * vi).sum(dim=1)),
                          min=1e-30)[:, None, :]
        return vr / nrm, vi / nrm

    Vr, Vi = back(Xr, Xi, 1.0 / scale)
    Wr, Wi = back(Yr, Yi, scale)
    return Vr, Vi, Wr, Wi, lam0_re, lam0_im, valid_r & valid_l


def eig_dd_batched(a: torch.Tensor) -> DDEigResult:
    """General real eigenvalues to (near-)f64 accuracy: one f32 Schur
    pass (``real_schur_vectors``) gives right AND left eigenvectors; the
    TWO-SIDED Rayleigh quotient ``λ = yᴴAv / yᴴv`` against the original
    matrix, in float64, is then second-order accurate (eigenvector errors
    ε contribute O(ε²/s)).  A lane whose ``s = |yᴴv|`` is below 1e-12
    (defective) keeps its Schur eigenvalue, flagged by ``s`` and
    ``err_bound``."""
    from .schur import real_schur_vectors

    a32 = a.to(_F32)
    n = a32.shape[-1]
    sv = real_schur_vectors(a32)
    Vr, Vi, Wr, Wi, lam0_re, lam0_im, valid = _eigvecs_two_sided(
        sv.T, sv.Q, sv.scale)
    Vr, Vi, Wr, Wi = (t.to(_F64) for t in (Vr, Vi, Wr, Wi))
    av = a32.to(_F64) @ torch.cat([Vr, Vi], dim=2)
    avr, avi = av[:, :, :n], av[:, :, n:]
    # yᴴ(Av) and yᴴv, y = Wr + i Wi
    num_re = (Wr * avr + Wi * avi).sum(dim=1)
    num_im = (Wr * avi - Wi * avr).sum(dim=1)
    den_re = (Wr * Vr + Wi * Vi).sum(dim=1)
    den_im = (Wr * Vi - Wi * Vr).sum(dim=1)
    den2 = den_re * den_re + den_im * den_im
    s = torch.sqrt(torch.clamp(den2, min=0.0))
    degenerate = s.to(_F32) < 1e-12
    den2 = torch.where(degenerate, 1.0, den2)
    lr = (num_re * den_re + num_im * den_im) / den2
    li = (num_im * den_re - num_re * den_im) / den2
    lr = torch.where(degenerate, lam0_re.to(_F64), lr)
    li = torch.where(degenerate, lam0_im.to(_F64), li)
    rr = avr - (lr[:, None, :] * Vr - li[:, None, :] * Vi)
    ri = avi - (lr[:, None, :] * Vi + li[:, None, :] * Vr)
    resid = torch.sqrt((rr * rr + ri * ri).sum(dim=1))
    lr_hi, lr_lo = _split(lr)
    li_hi, li_lo = _split(li)
    s32, resid32 = s.to(_F32), resid.to(_F32)
    err_bound = resid32 / torch.clamp(s32, min=1e-30)
    return DDEigResult(lr_hi, lr_lo, li_hi, li_lo, s32, resid32, err_bound,
                       valid, sv.converged)
