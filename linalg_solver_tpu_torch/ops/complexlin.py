"""Batched COMPLEX dense linear algebra on the real kernels (counterpart of
``linalg_solver_tpu.ops.complexlin``).

As in the reference, complex data travels as (re, im) pairs, and every
operation that has a real path of the port runs there through the real
``2n × 2n`` embedding ``M = [[X, −Y], [Y, X]]`` of ``X + iY`` (an algebra
isomorphism: products, sums, inverses, solves, polar factors and
real-coefficient power series commute with it): the solve and inverse
(``ops.dispatch``, kernels 1–6), ``eigh`` and ``eig`` (the symmetric
solver, the Schur kernels), the SVD's polar factor (QDWH), expm, sqrtm
and logm (``ops.funm``), Sylvester and Lyapunov (``ops.sylvester``), the
generalized problem's reduction and the dd solve.  A native complex64
solve, inverse or eig would be the library's (cuSOLVER) where the
reference runs its own kernels, so native complex tensors serve only as
glue (``_cmatmul``, the products of CholeskyQR2).

The determinant cannot use the embedding (``det(embed(M)) = |det M|²``
loses the phase): ``_gauss_pivots_complex`` eliminates in complex
arithmetic on the hand-written kernel ``ops.kernels.complex_gauss`` (the
reference's XLA ``fori_loop``), and ``det`` / ``slogdet`` take their
products over the pivots.  ``eig``'s conjugate-partner selection and
``eigh``'s degenerate repair stay on the host, a lane at a time, as in
the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.precision import f32_matmuls

#: seed of ``complete_basis_complex_batched``'s default Gaussian block
#: (the reference draws it from ``PRNGKey(7)``)
BASIS_SEED = 7


def _real_dtype(t: torch.Tensor):
    return torch.promote_types(t.dtype, torch.float32)


def _embed(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """[B, n, n] pair → [B, 2n, 2n] real embedding [[X, −Y], [Y, X]]."""
    return torch.cat([torch.cat([re, -im], dim=2),
                      torch.cat([im, re], dim=2)], dim=1)


def solve_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor,
    b_re: torch.Tensor, b_im: torch.Tensor,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve complex square systems ``(A_re + i·A_im) x = b_re + i·b_im``
    (``b`` vectors ``[B, n]``) through ``dispatch.solve_batched`` on the
    embedding; returns ``(x_re, x_im)``."""
    from . import dispatch

    n = a_re.shape[-1]
    x = dispatch.solve_batched(_embed(a_re, a_im),
                               torch.cat([b_re, b_im], dim=1),
                               backend=backend)
    return x[:, :n], x[:, n:]


def inverse_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor, backend: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of complex batches through ``dispatch.inverse_batched`` on
    the embedding; returns ``(inv_re, inv_im)``."""
    from . import dispatch

    n = a_re.shape[-1]
    inv = dispatch.inverse_batched(_embed(a_re, a_im), backend=backend)
    # inv is the embedding of A⁻¹: read off its blocks
    return inv[:, :n, :n], inv[:, n:, :n]


def _gauss_pivots_complex(a_re: torch.Tensor, a_im: torch.Tensor):
    """Pivoted complex Gauss elimination on the kernel
    (``kernels.complex_gauss``); returns per-step ``(pivots_re,
    pivots_im, sign, ok)`` with ``det = sign·Π pivot[k]``."""
    from .kernels.complex_gauss import gauss_pivots_complex

    f = _real_dtype(a_re)
    return gauss_pivots_complex(a_re.to(f), a_im.to(f))


def det_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex determinant; returns ``(det_re, det_im)``, 0 where a step
    found no pivot.  The embedding loses the phase, so this runs the
    direct complex elimination (``_gauss_pivots_complex``) and takes the
    product of its pivots."""
    pr, pi, sg, ok = _gauss_pivots_complex(a_re, a_im)
    d = torch.complex(pr, pi).prod(dim=1) * sg
    zero = torch.zeros_like(sg)
    return torch.where(ok, d.real, zero), torch.where(ok, d.imag, zero)


def slogdet_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sign_re, sign_im, log|det|)`` with ``sign`` the unit-modulus
    phase (numpy ``slogdet`` semantics for complex input); finite where
    the plain product over- or underflows.  Singular lanes: sign 0,
    logabs −inf."""
    pr, pi, sg, ok = _gauss_pivots_complex(a_re, a_im)
    safe = torch.clamp(pr * pr + pi * pi, min=1e-37)
    logabs = 0.5 * torch.log(safe).sum(dim=1)
    inv = torch.rsqrt(safe)
    s = torch.complex(pr * inv, pi * inv).prod(dim=1) * sg
    zero = torch.zeros_like(sg)
    return (torch.where(ok, s.real, zero), torch.where(ok, s.imag, zero),
            torch.where(ok, logabs, torch.full_like(logabs, -torch.inf)))


class ComplexEighResult(NamedTuple):
    """Hermitian complex eigendecomposition.  ``ok=False`` marks lanes
    where the doubled-pair extraction lost complex independence (only for
    degenerate eigenvalues with adversarial basis mixing), verified by
    ``VᴴV`` and the eigen residual."""

    w: torch.Tensor      # [B, n] ascending real eigenvalues
    v_re: torch.Tensor   # [B, n, n]
    v_im: torch.Tensor   # [B, n, n]
    ok: torch.Tensor     # [B]


def _repair_degenerate(V, w_all, w, v_re, v_im, ok, converged):
    """Re-select the flagged lanes' eigenvectors on the host by complex
    MGS over all 2n candidates in ascending order (the embedding's 2m-dim
    eigenspace of an m-fold eigenvalue holds J-partners, complex-dependent,
    which the every-other selection can pick together)."""
    n = w.shape[1]
    ok_np = ok.cpu().numpy()
    Vfull = V.cpu().double().numpy()
    wfull = w_all.cpu().double().numpy()
    w_h, vr_h, vi_h = (t.cpu().numpy().copy() for t in (w, v_re, v_im))
    fixed = ok_np.copy()
    for b in np.nonzero(~ok_np)[0]:
        kept, kw = [], []
        for j in range(2 * n):
            c = Vfull[b, :n, j] + 1j * Vfull[b, n:, j]
            for kvec in kept:
                c = c - (kvec.conj() @ c) * kvec
            nc = np.linalg.norm(c)
            if nc > 0.3:
                kept.append(c / nc)
                kw.append(wfull[b, j])
            if len(kept) == n:
                break
        if len(kept) == n:
            Vc = np.stack(kept, axis=1)
            w_h[b] = np.asarray(kw, w_h.dtype)
            vr_h[b] = Vc.real.astype(vr_h.dtype)
            vi_h[b] = Vc.imag.astype(vi_h.dtype)
            fixed[b] = True
    dev = w.device
    return (torch.from_numpy(w_h).to(dev), torch.from_numpy(vr_h).to(dev),
            torch.from_numpy(vi_h).to(dev),
            torch.from_numpy(fixed).to(dev) & converged)


@f32_matmuls()
def eigh_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor
) -> ComplexEighResult:
    """Eigendecomposition of batched HERMITIAN complex matrices ``A = X +
    iY`` (X symmetric, Y antisymmetric; the inputs are projected).

    The embedding is symmetric with every eigenvalue of A doubled, and its
    2-dim real eigenspaces map onto A's 1-dim complex ones by ``[p; q] ↦
    p + iq``, so one real ``eigh`` of the 2n problem and an every-other
    selection of the ascending pairs give the complex decomposition, with
    unit complex eigenvectors."""
    from .symmetric import eigh_batched

    f = _real_dtype(a_re)
    X = (0.5 * (a_re + a_re.mT)).to(f)
    Y = (0.5 * (a_im - a_im.mT)).to(f)
    n = X.shape[-1]
    r = eigh_batched(_embed(X, Y))
    w = r.w[:, 0::2]
    v_re = r.V[:, :n, 0::2]
    v_im = r.V[:, n:, 0::2]
    # complex orthonormality VᴴV = I catches a doubled pair selected
    # twice, the residual a pair-straddling selection
    g_re = v_re.mT @ v_re + v_im.mT @ v_im
    g_im = v_re.mT @ v_im - v_im.mT @ v_re
    eye = torch.eye(n, dtype=f, device=X.device)
    orth_err = ((g_re - eye).abs() + g_im.abs()).amax(dim=(1, 2))
    av_re = X @ v_re - Y @ v_im
    av_im = X @ v_im + Y @ v_re
    res = torch.sqrt(((av_re - w[:, None, :] * v_re) ** 2
                      + (av_im - w[:, None, :] * v_im) ** 2).sum(dim=1))
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-30)
    tol = 64.0 * n * torch.finfo(f).eps
    ok = r.converged & (orth_err < tol * n) & (res.amax(dim=1) < tol * scale)
    if not bool(ok.all()):
        w, v_re, v_im, ok = _repair_degenerate(r.V, r.w, w, v_re, v_im, ok,
                                               r.converged)
    return ComplexEighResult(w, v_re, v_im, ok)


class ComplexEigResult(NamedTuple):
    """General complex eigendecomposition (eigenvalues in no particular
    order; ``valid`` per column, ``ok`` per lane gates the A-block
    extraction count and the residuals)."""

    real: torch.Tensor   # [B, n]
    imag: torch.Tensor   # [B, n]
    v_re: torch.Tensor   # [B, n, n]
    v_im: torch.Tensor   # [B, n, n]
    valid: torch.Tensor  # [B, n]
    ok: torch.Tensor     # [B]


def _select_a_block(unorm, valid_in, lam_all, u_h):
    """The reference's greedy pair-consuming selection, a lane at a time
    on the host: ``spec(M) = S ⊎ conj(S)`` pairs every A-eigenvalue with a
    conjugate partner; picking a column retires that partner, and a pick
    must be complex-independent of the same cluster's picks.  Returns the
    picked columns ``[B, n]`` and each lane's ``ok``."""
    B, two_n = unorm.shape
    n = two_n // 2
    score = np.where(valid_in, unorm, -1.0)
    idx = np.zeros((B, n), np.int64)
    ok_sel = np.zeros(B, bool)
    lam_scale = np.maximum(np.abs(lam_all).max(axis=1), 1e-30)
    for b in range(B):
        alive = valid_in[b].copy()
        tried = np.zeros(two_n, bool)
        kept_u, kept_lam, picked = [], [], []
        pair_ok = True
        ctol = 1e-3 * lam_scale[b]
        for j in np.argsort(-score[b], kind="stable"):
            if len(picked) == n:
                break
            if not alive[j] or tried[j]:
                continue  # consumed as a partner / known duplicate
            if score[b, j] <= 1e-3:
                break  # the remaining candidates are conj-block copies
            c = u_h[b, :, j] / max(np.linalg.norm(u_h[b, :, j]), 1e-30)
            for kl, ku in zip(kept_lam, kept_u):
                if abs(kl - lam_all[b, j]) < ctol:
                    c = c - (ku.conj() @ c) * ku
            if np.linalg.norm(c) < 0.3:
                tried[j] = True  # duplicate copy: partner only
                continue
            cand = np.nonzero(alive)[0]
            cand = cand[cand != j]
            if cand.size == 0:
                break
            k = cand[np.argmin(np.abs(lam_all[b, cand]
                                      - lam_all[b, j].conj()))]
            if abs(lam_all[b, k] - lam_all[b, j].conj()) \
                    > 1e-2 * lam_scale[b]:
                pair_ok = False  # multiset structure broken
            alive[j] = False
            alive[k] = False
            kept_u.append(c / np.linalg.norm(c))
            kept_lam.append(lam_all[b, j])
            picked.append(j)
        if len(picked) == n:
            idx[b] = picked
            ok_sel[b] = pair_ok
    return idx, ok_sel


@f32_matmuls()
def eig_complex_batched(a_re: torch.Tensor, a_im: torch.Tensor
                        ) -> ComplexEigResult:
    """Eigendecomposition of batched GENERAL complex matrices through the
    embedding ``M`` and ``schur.eig_batched`` (the Schur kernels).

    ``M ≅ A ⊕ conj(A)``: for an eigenpair ``(λ, [a; b])`` of M, ``u = a +
    ib`` satisfies ``A u = λ u``, and ``u ≡ 0`` exactly on the
    conj-block copies.  The A-block columns are picked greedily by
    descending ‖u‖, consuming each pick's conjugate partner
    (``_select_a_block``, on the host), and verified by true complex
    residuals."""
    from .schur import eig_batched

    f = _real_dtype(a_re)
    X, Y = a_re.to(f), a_im.to(f)
    n = X.shape[-1]
    eg = eig_batched(_embed(X, Y))
    vr, vi = eg.vectors_real, eg.vectors_imag
    u_re = vr[:, :n, :] - vi[:, n:, :]
    u_im = vi[:, :n, :] + vr[:, n:, :]
    unorm = torch.sqrt((u_re ** 2 + u_im ** 2).sum(dim=1))     # [B, 2n]
    lam_all = (eg.real.cpu().double().numpy()
               + 1j * eg.imag.cpu().double().numpy())
    u_h = (u_re.cpu().double().numpy() + 1j * u_im.cpu().double().numpy())
    idx, ok_sel = _select_a_block(unorm.cpu().numpy(),
                                  eg.valid.cpu().numpy(), lam_all, u_h)
    idx = torch.from_numpy(idx).to(X.device)
    cols = idx[:, None, :].expand(-1, n, -1)
    u_re = torch.gather(u_re, 2, cols)
    u_im = torch.gather(u_im, 2, cols)
    lam_re = torch.gather(eg.real, 1, idx)
    lam_im = torch.gather(eg.imag, 1, idx)
    valid = torch.gather(eg.valid, 1, idx)
    nrm = torch.clamp(torch.sqrt((u_re ** 2 + u_im ** 2).sum(dim=1)),
                      min=1e-30)[:, None, :]
    u_re, u_im = u_re / nrm, u_im / nrm
    # true complex residuals ‖A v − λ v‖
    av_re = X @ u_re - Y @ u_im
    av_im = X @ u_im + Y @ u_re
    rr = av_re - (lam_re[:, None, :] * u_re - lam_im[:, None, :] * u_im)
    ri = av_im - (lam_re[:, None, :] * u_im + lam_im[:, None, :] * u_re)
    res = torch.sqrt((rr * rr + ri * ri).sum(dim=1))
    scale = torch.clamp((X.abs() + Y.abs()).amax(dim=(1, 2)), min=1e-30)
    valid = valid & (res < 1e-2 * scale[:, None])
    ok = (torch.from_numpy(ok_sel).to(X.device) & eg.converged
          & valid.all(dim=1))
    return ComplexEigResult(lam_re, lam_im, u_re, u_im, valid, ok)


def _cmatmul(ar, ai, br, bi, ta: bool = False):
    """Complex product ``A·B`` (or ``Aᴴ·B`` with ``ta=True``) on (re, im)
    pairs, as one complex matmul in full float32."""
    a = torch.complex(ar, ai)
    if ta:
        a = a.mH
    with f32_matmuls():
        c = a @ torch.complex(br, bi)
    return c.real, c.imag


class ComplexCholResult(NamedTuple):
    """Complex Cholesky ``A = L·Lᴴ`` (L lower triangular, real positive
    diagonal).  ``ok=False`` flags lanes that are not Hermitian positive
    definite (their L is garbage past the failing pivot)."""

    l_re: torch.Tensor
    l_im: torch.Tensor
    ok: torch.Tensor


def chol_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor
) -> ComplexCholResult:
    """Cholesky of batched HERMITIAN-PD complex matrices: right-looking
    rank-1 updates in re/im arithmetic, n batched steps, as the reference
    (``chol(embed(A)) ≠ embed(chol(A))``: the embedding of a triangular
    matrix is not triangular)."""
    f = _real_dtype(a_re)
    re = a_re.to(f)
    re = 0.5 * (re + re.mT)
    im = (0.5 * (a_im - a_im.mT)).to(f)
    B, n, _ = re.shape
    rows = torch.arange(n, device=re.device)
    lr = torch.zeros_like(re)
    li = torch.zeros_like(re)
    ok = torch.ones(B, dtype=torch.bool, device=re.device)
    for k in range(n):
        d = re[:, k, k]                    # real for Hermitian A
        ok = ok & (d > 0)
        inv = torch.rsqrt(torch.where(d > 0, d, 1.0))[:, None]
        mask = (rows >= k).to(f)[None, :]
        cr = re[:, :, k] * mask * inv
        ci = im[:, :, k] * mask * inv
        lr[:, :, k] = cr
        li[:, :, k] = ci
        # trailing update A −= c cᴴ, (c cᴴ)_ij = c_i conj(c_j)
        re = re - (cr[:, :, None] * cr[:, None, :]
                   + ci[:, :, None] * ci[:, None, :])
        im = im - (ci[:, :, None] * cr[:, None, :]
                   - cr[:, :, None] * ci[:, None, :])
    return ComplexCholResult(lr, li, ok)


class ComplexQRResult(NamedTuple):
    """Thin complex QR: ``A = Q·R``, Q [B, m, n] with QᴴQ = I, R upper
    triangular with real positive diagonal (LAPACK convention)."""

    q_re: torch.Tensor
    q_im: torch.Tensor
    r_re: torch.Tensor
    r_im: torch.Tensor
    ok: torch.Tensor


def qr_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor
) -> ComplexQRResult:
    """Thin QR of batched complex ``[B, m, n]`` (m ≥ n, full column rank)
    by complex CholeskyQR2: two passes of ``G = AᴴA; L = chol(G); Q =
    A·L⁻ᴴ``, the triangular inverse through ``inverse_complex_batched``
    on the embedding."""
    G_re, G_im = _cmatmul(a_re, a_im, a_re, a_im, ta=True)
    c1 = chol_complex_batched(G_re, G_im)
    il1_re, il1_im = inverse_complex_batched(c1.l_re, c1.l_im)
    # Q1 = A · L⁻ᴴ
    q_re, q_im = _cmatmul(a_re, a_im, il1_re.mT, -il1_im.mT)
    G2_re, G2_im = _cmatmul(q_re, q_im, q_re, q_im, ta=True)
    c2 = chol_complex_batched(G2_re, G2_im)
    il2_re, il2_im = inverse_complex_batched(c2.l_re, c2.l_im)
    q_re, q_im = _cmatmul(q_re, q_im, il2_re.mT, -il2_im.mT)
    # R = L2ᴴ · L1ᴴ  (A = Q2 (L2ᴴ L1ᴴ))
    r_re, r_im = _cmatmul(c2.l_re.mT, -c2.l_im.mT,
                          c1.l_re.mT, -c1.l_im.mT)
    return ComplexQRResult(q_re, q_im, r_re, r_im, c1.ok & c2.ok)


class ComplexSVDResult(NamedTuple):
    """Thin complex SVD ``A = U diag(s) Vᴴ`` (s descending ≥ 0)."""

    u_re: torch.Tensor
    u_im: torch.Tensor
    s: torch.Tensor
    v_re: torch.Tensor
    v_im: torch.Tensor
    ok: torch.Tensor


def svd_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor, iters: int = 8
) -> ComplexSVDResult:
    """Thin SVD of batched complex ``[B, m, n]`` (any shape).  The QDWH
    polar factor of ``embed(A)`` is ``embed(U_polar(A))`` (uniqueness of
    the polar decomposition), so ``svd.polar_batched`` does the heavy
    lifting; its blocks are read off (averaged: their agreement is part
    of ``ok``), then ``H = Uᴴ A`` is Hermitian PSD and
    ``eigh_complex_batched`` finishes (host-driven, like it)."""
    from .svd import polar_batched

    B, m, n = a_re.shape
    if m < n:
        r = svd_complex_batched(a_re.mT, -a_im.mT, iters=iters)
        # A = (Aᴴ)ᴴ = (U' s V'ᴴ)ᴴ = V' s U'ᴴ
        return ComplexSVDResult(r.v_re, r.v_im, r.s, r.u_re, r.u_im, r.ok)
    f = _real_dtype(a_re)
    a_re, a_im = a_re.to(f), a_im.to(f)
    pol = polar_batched(_embed(a_re, a_im), iters=iters)
    up = pol.up
    u_re = 0.5 * (up[:, :m, :n] + up[:, m:, n:])
    u_im = 0.5 * (up[:, m:, :n] - up[:, :m, n:])
    emb_err = (up - _embed(u_re, u_im)).abs().amax(dim=(1, 2))
    h_re, h_im = _cmatmul(u_re, u_im, a_re, a_im, ta=True)
    eh = eigh_complex_batched(h_re, h_im)
    s = torch.clamp(eh.w.flip(1), min=0.0)
    v_re, v_im = eh.v_re.flip(2), eh.v_im.flip(2)
    su_re, su_im = _cmatmul(u_re, u_im, v_re, v_im)
    ok = pol.ok & eh.ok & (emb_err < 1e-3)
    return ComplexSVDResult(su_re, su_im, s, v_re, v_im, ok)


def _amax_c(re, im):
    return torch.clamp((re.abs() + im.abs()).amax(dim=(1, 2)), min=1e-30)


def pinv_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor, rcond: Optional[float] = None
):
    """Moore–Penrose pseudoinverse of batched complex matrices by the
    complex SVD: ``A⁺ = V Σ⁺ Uᴴ`` (numpy's default cutoff ``rcond =
    max(m, n)·eps``).  Returns ``(re, im, ok)``, ``ok`` from the Penrose
    identities ``A A⁺ A = A`` and ``A⁺ A A⁺ = A⁺`` checked directly."""
    B, m, n = a_re.shape
    r = svd_complex_batched(a_re, a_im)
    if rcond is None:
        rcond = max(m, n) * torch.finfo(r.s.dtype).eps
    cut = rcond * r.s.amax(dim=1, keepdim=True)
    sinv = torch.where(r.s > cut, 1.0 / torch.clamp(r.s, min=1e-37), 0.0)
    vr = r.v_re * sinv[:, None, :]
    vi = r.v_im * sinv[:, None, :]
    # (V Σ⁺) Uᴴ
    p_re, p_im = _cmatmul(vr, vi, r.u_re.mT, -r.u_im.mT)
    ap_re, ap_im = _cmatmul(a_re, a_im, p_re, p_im)
    apa_re, apa_im = _cmatmul(ap_re, ap_im, a_re, a_im)
    pap_re, pap_im = _cmatmul(p_re, p_im, ap_re, ap_im)
    e1 = ((apa_re - a_re).abs() + (apa_im - a_im).abs()).amax(dim=(1, 2))
    e2 = ((pap_re - p_re).abs() + (pap_im - p_im).abs()).amax(dim=(1, 2))
    ok = (e1 < 1e-3 * _amax_c(a_re, a_im)) & (e2 < 1e-3 * _amax_c(p_re, p_im))
    return p_re, p_im, ok


def lstsq_complex_batched(
    a_re: torch.Tensor, a_im: torch.Tensor,
    b_re: torch.Tensor, b_im: torch.Tensor,
):
    """Minimum-norm least-squares solution of complex ``A x ≈ b`` (``b``
    vectors ``[B, m]``) through the complex pseudoinverse; returns
    ``(x_re, x_im, ok)``."""
    p_re, p_im, ok = pinv_complex_batched(a_re, a_im)
    x_re, x_im = _cmatmul(p_re, p_im, b_re[:, :, None], b_im[:, :, None])
    return x_re[:, :, 0], x_im[:, :, 0], ok


def _extract(M: torch.Tensor, m: int, n: int):
    """Read the (re, im) blocks off an (approximately) embedded ``[B, 2m,
    2n]`` matrix, plus the relative embedding-structure error."""
    re = 0.5 * (M[:, :m, :n] + M[:, m:, n:])
    im = 0.5 * (M[:, m:, :n] - M[:, :m, n:])
    err = (M - _embed(re, im)).abs().amax(dim=(1, 2))
    scale = torch.clamp(M.abs().amax(dim=(1, 2)), min=1e-30)
    return re, im, err / scale


def expm_complex_batched(a_re: torch.Tensor, a_im: torch.Tensor):
    """Complex matrix exponential, ``expm(embed(A)) = embed(expm(A))``,
    on ``funm.expm_batched``.  Returns ``(re, im, ok)``, ``ok`` gating the
    result's embedded structure."""
    from .funm import expm_batched

    f = _real_dtype(a_re)
    n = a_re.shape[-1]
    E = expm_batched(_embed(a_re.to(f), a_im.to(f)))
    re, im, err = _extract(E, n, n)
    return re, im, (err < 1e-4) & torch.isfinite(E).all(dim=(1, 2))


def sqrtm_complex_batched(a_re: torch.Tensor, a_im: torch.Tensor):
    """Principal complex square root by the embedded Denman–Beavers
    iteration (``funm.sqrtm_batched``; no eigenvalue on ℝ⁻, for A as for
    its embedding).  Returns ``(re, im, ok)``."""
    from .funm import sqrtm_batched

    f = _real_dtype(a_re)
    n = a_re.shape[-1]
    r = sqrtm_batched(_embed(a_re.to(f), a_im.to(f)))
    re, im, err = _extract(r.Y, n, n)
    return re, im, r.converged & (err < 1e-4)


def logm_complex_batched(a_re: torch.Tensor, a_im: torch.Tensor):
    """Principal complex logarithm by the embedded inverse scaling and
    squaring (``funm.logm_batched``).  Returns ``(re, im, ok)``."""
    from .funm import logm_batched

    f = _real_dtype(a_re)
    n = a_re.shape[-1]
    r = logm_batched(_embed(a_re.to(f), a_im.to(f)))
    re, im, err = _extract(r.L, n, n)
    return re, im, r.converged & (err < 1e-4)


def funm_hermitian_batched(a_re: torch.Tensor, a_im: torch.Tensor, f):
    """``f(A) = V f(Λ) Vᴴ`` for a HERMITIAN complex matrix; ``f`` maps a
    real eigenvalue tensor to a real tensor.  Returns ``(re, im, ok)``;
    host-driven (the degenerate-eigh repair)."""
    eh = eigh_complex_batched(a_re, a_im)
    fw = f(eh.w)
    re, im = _cmatmul(eh.v_re * fw[:, None, :], eh.v_im * fw[:, None, :],
                      eh.v_re.mT, -eh.v_im.mT)
    return re, im, eh.ok


def funm_complex_batched(a_re: torch.Tensor, a_im: torch.Tensor, f):
    """``f(A) = V f(Λ) V⁻¹`` for a GENERAL complex matrix; ``f`` takes a
    complex ``[B, n]`` eigenvalue tensor and returns complex.  Returns
    ``(re, im, resid, ok)`` with ``resid`` the relative reconstruction
    error of the diagonalization (it grows with κ(V))."""
    r = eig_complex_batched(a_re, a_im)
    fr_dtype = _real_dtype(a_re)
    lam = torch.complex(r.real.to(fr_dtype), r.imag.to(fr_dtype))
    fd = torch.as_tensor(f(lam), device=lam.device)
    fr, fi = fd.real.to(fr_dtype), fd.imag.to(fr_dtype)
    vinv_re, vinv_im = inverse_complex_batched(r.v_re, r.v_im)
    w_re = r.v_re * fr[:, None, :] - r.v_im * fi[:, None, :]
    w_im = r.v_re * fi[:, None, :] + r.v_im * fr[:, None, :]
    F_re, F_im = _cmatmul(w_re, w_im, vinv_re, vinv_im)
    # the reconstruction with the same V, V⁻¹ (f = identity)
    z_re = r.v_re * r.real[:, None, :] - r.v_im * r.imag[:, None, :]
    z_im = r.v_re * r.imag[:, None, :] + r.v_im * r.real[:, None, :]
    A_re, A_im = _cmatmul(z_re, z_im, vinv_re, vinv_im)
    resid = ((A_re - a_re).abs() + (A_im - a_im).abs()).amax(dim=(1, 2)) \
        / _amax_c(a_re, a_im)
    n = a_re.shape[-1]
    ok = r.ok & (resid <= 1e3 * n * torch.finfo(fr_dtype).eps)
    return F_re, F_im, resid, ok


def sylvester_complex_batched(a_re, a_im, b_re, b_im, c_re, c_im):
    """Complex Sylvester equation ``A X + X B = C`` through the embedded
    real equation (``sylvester.sylvester_batched``), whose unique
    solution is ``embed(X)`` where it exists.  The embedded equation also
    needs ``conj spec A ∩ −spec B = ∅`` (``A = [i], B = [i]`` embeds
    singularly); ``ok`` checks the true residual ``‖AX + XB − C‖``, so
    such lanes report False.  Returns ``(x_re, x_im, ok)``."""
    from .sylvester import sylvester_batched

    f = _real_dtype(a_re)
    n, m = a_re.shape[-1], b_re.shape[-1]
    a_re, a_im, b_re, b_im, c_re, c_im = (
        t.to(f) for t in (a_re, a_im, b_re, b_im, c_re, c_im))
    r = sylvester_batched(_embed(a_re, a_im), _embed(b_re, b_im),
                          _embed(c_re, c_im))
    x_re, x_im, emb_err = _extract(r.X, n, m)
    ax_re, ax_im = _cmatmul(a_re, a_im, x_re, x_im)
    xb_re, xb_im = _cmatmul(x_re, x_im, b_re, b_im)
    res = ((ax_re + xb_re - c_re).abs()
           + (ax_im + xb_im - c_im).abs()).amax(dim=(1, 2))
    scale = torch.clamp(
        ((a_re.abs() + a_im.abs()).amax(dim=(1, 2))
         + (b_re.abs() + b_im.abs()).amax(dim=(1, 2)))
        * torch.clamp((x_re.abs() + x_im.abs()).amax(dim=(1, 2)), min=1.0),
        min=1e-30)
    ok = r.ok & (emb_err < 1e-3) & (res < 1e-3 * scale)
    return x_re, x_im, ok


def lyapunov_complex_batched(a_re, a_im, q_re, q_im):
    """Continuous complex Lyapunov equation ``A X + X Aᴴ = Q`` (Sylvester
    with ``B = Aᴴ``)."""
    return sylvester_complex_batched(a_re, a_im, a_re.mT, -a_im.mT,
                                     q_re, q_im)


class ComplexGeigResult(NamedTuple):
    """Complex generalized eigenproblem ``A v = λ B v`` (B invertible).
    ``rcond_b`` estimates B's reciprocal condition from the embedded LU;
    the eigenvalue error scales with ``1/rcond_b``."""

    real: torch.Tensor
    imag: torch.Tensor
    v_re: torch.Tensor
    v_im: torch.Tensor
    valid: torch.Tensor
    ok: torch.Tensor
    rcond_b: torch.Tensor


def eig_generalized_complex_batched(a_re, a_im, b_re, b_im
                                    ) -> ComplexGeigResult:
    """Complex ``A v = λ B v`` by reduction to ``B⁻¹A``: one embedded
    solve with the embedded A as its right-hand side gives
    ``embed(B⁻¹A)`` (``lu_blocked.blocked_solve_batched`` where a panel
    of 64, 48, 32, 16 or 8 tiles 2n ≥ 16, else the LU loop), then
    ``eig_complex_batched``.  Eigenvector residuals are checked against
    the true pencil ``‖A v − λ B v‖``."""
    from .cond import rcond_batched
    from .lu import lu_factor_batched, lu_solve_batched
    from .lu_blocked import blocked_solve_batched

    f = _real_dtype(a_re)
    n = a_re.shape[-1]
    a_re, a_im, b_re, b_im = (t.to(f) for t in (a_re, a_im, b_re, b_im))
    Be, Ae = _embed(b_re, b_im), _embed(a_re, a_im)
    nn = 2 * n
    nb = next((w for w in (64, 48, 32, 16, 8) if nn % w == 0), None)
    if nb is not None and nn >= 16:
        Z = blocked_solve_batched(Be, Ae, nb=nb)
    else:
        Z = lu_solve_batched(lu_factor_batched(Be), Ae)
    m_re, m_im, emb_err = _extract(Z, n, n)
    eg = eig_complex_batched(m_re, m_im)
    av_re, av_im = _cmatmul(a_re, a_im, eg.v_re, eg.v_im)
    bv_re, bv_im = _cmatmul(b_re, b_im, eg.v_re, eg.v_im)
    lr, li = eg.real[:, None, :], eg.imag[:, None, :]
    rr = av_re - (lr * bv_re - li * bv_im)
    ri = av_im - (lr * bv_im + li * bv_re)
    res_c = torch.sqrt((rr * rr + ri * ri).sum(dim=1))
    scale = torch.clamp(
        (a_re.abs() + a_im.abs()).amax(dim=(1, 2))[:, None]
        + torch.sqrt((lr * lr + li * li)[:, 0, :])
        * (b_re.abs() + b_im.abs()).amax(dim=(1, 2))[:, None], min=1e-30)
    valid = eg.valid & (res_c < 1e-2 * scale)
    rc = rcond_batched(Be)
    ok = eg.ok & (emb_err < 1e-3) & (rc > 0)
    return ComplexGeigResult(eg.real, eg.imag, eg.v_re, eg.v_im, valid, ok,
                             rc)


class ComplexRootsResult(NamedTuple):
    real: torch.Tensor
    imag: torch.Tensor
    ok: torch.Tensor


def roots_complex_batched(c_re: torch.Tensor, c_im: torch.Tensor
                          ) -> ComplexRootsResult:
    """All d roots of batched degree-d polynomials with COMPLEX
    coefficients (descending order, ``c[:, 0]`` leading): the complex
    companion matrix through ``eig_complex_batched``."""
    B, dp1 = c_re.shape
    d = dp1 - 1
    if d < 1:
        raise ValueError("need degree >= 1 (at least 2 coefficients)")
    f = _real_dtype(c_re)
    c_re, c_im = c_re.to(f), c_im.to(f)
    lead2 = c_re[:, 0] ** 2 + c_im[:, 0] ** 2
    ok = lead2 > 0
    safe = torch.where(ok, lead2, 1.0)[:, None]
    # monic = c[1:] / c[0] (complex divide)
    mr = (c_re[:, 1:] * c_re[:, :1] + c_im[:, 1:] * c_im[:, :1]) / safe
    mi = (c_im[:, 1:] * c_re[:, :1] - c_re[:, 1:] * c_im[:, :1]) / safe
    comp_re = torch.diag(torch.ones(d - 1, dtype=f, device=c_re.device),
                         -1).expand(B, d, d).clone()
    comp_re[:, 0, :] = -mr
    comp_im = torch.zeros_like(comp_re)
    comp_im[:, 0, :] = -mi
    eg = eig_complex_batched(comp_re, comp_im)
    return ComplexRootsResult(eg.real, eg.imag, ok & eg.ok)


def solve_complex_dd_batched(
    a_re: torch.Tensor, a_im: torch.Tensor,
    b_re: torch.Tensor, b_im: torch.Tensor,
):
    """Complex solve to f64-CLASS backward error: the embedding composed
    with ``dd.solve_dd_batched``.  Returns ``(x_re, x_im, resid, ok)``
    with the collapsed refined solution (the embedding is exact, so the
    complex backward error is the real one)."""
    from .dd import solve_dd_batched

    n = a_re.shape[-1]
    r = solve_dd_batched(_embed(a_re, a_im), torch.cat([b_re, b_im], dim=1))
    x = r.x_hi + r.x_lo
    return x[:, :n], x[:, n:], r.resid, r.ok


def complete_basis_complex_batched(
    u_re: torch.Tensor, u_im: torch.Tensor,
    w_re: Optional[torch.Tensor] = None, w_im: Optional[torch.Tensor] = None,
):
    """Orthonormal complement of complex orthonormal columns ``u [B, m,
    k]`` (k < m): ``[B, m, m − k]`` (re, im) with ``[u | complement]``
    unitary.  A fixed Gaussian block ``w [m, m − k]`` is projected onto
    ``range(u)^⊥`` and orthonormalized by complex CholeskyQR2, twice.
    ``w_re``, ``w_im`` default to draws from a CPU ``torch.Generator``
    seeded with ``BASIS_SEED`` (re first), moved to ``u``'s device; the
    reference's draw (``PRNGKey(7)``) is another one, so tests pass it
    in."""
    B, m, k = u_re.shape
    r = m - k
    f = _real_dtype(u_re)
    u_re, u_im = u_re.to(f), u_im.to(f)
    if w_re is None or w_im is None:
        g = torch.Generator().manual_seed(BASIS_SEED)
        w_re = torch.randn((m, r), generator=g, dtype=f)
        w_im = torch.randn((m, r), generator=g, dtype=f)
    w_re = w_re.to(device=u_re.device, dtype=f).expand(B, m, r)
    w_im = w_im.to(device=u_re.device, dtype=f).expand(B, m, r)
    for _ in range(2):
        p_re, p_im = _cmatmul(u_re, u_im, w_re, w_im, ta=True)
        q_re, q_im = _cmatmul(u_re, u_im, p_re, p_im)
        qr = qr_complex_batched(w_re - q_re, w_im - q_im)
        w_re, w_im = qr.q_re, qr.q_im
    return w_re, w_im
