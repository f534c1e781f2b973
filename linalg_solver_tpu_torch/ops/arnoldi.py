"""Batched matrix-free Arnoldi (Krylov–Schur) for a few eigenpairs of
general real operators (counterpart of ``linalg_solver_tpu.ops.arnoldi``).

1. **Expansion**: grow ``A U_m = U_m S + β u⁺ eₘᵀ`` by CGS2 Arnoldi steps
   (two classical Gram–Schmidt passes of batched products).  A lane whose
   new direction vanishes (an invariant subspace) gets a fresh random
   direction orthonormalized against the basis, with zero coupling, so
   the decomposition stays exact.
2. **Contraction**: the Rayleigh matrix ``S [B, m, m]`` goes through
   ``ops.schur.eig_batched`` (the Schur chase and window kernels); the
   wanted Ritz values are picked on the host, conjugate pairs whole
   (``_select_host``: one read a restart, as in the reference), the kept
   basis is orthonormalized (``ops.orth``) and the expansion resumes at
   column k + 1.
3. The returned ``resid`` / ``converged`` come from true matvecs on the
   final Ritz vectors (complex pairs in re/im arithmetic).

The splice directions of restart ``it`` are ``[m, B, n]`` standard
normals, drawn on a CPU ``torch.Generator`` seeded ``SPLICE_SEED`` (the
reference's ``PRNGKey(7)``) once a restart, or given by ``splice(it)``
(tests feed the JAX package's draw).  Products run in true float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.precision import f32_matmuls
from . import krylov
from .orth import orthonormal_columns

#: generator seed of the splice draws and of the default start vector
SPLICE_SEED = 7
V0_SEED = 0


class ArnoldiEigs(NamedTuple):
    """Top-k Ritz pairs; a complex pair lists its ``+imag`` member first
    (when the k-th slot is a pair's first member its conjugate is not
    listed).  ``resid`` is the true relative residual ``‖Av − λv‖ /
    scale`` (scale: the lane's largest Ritz magnitude); ``converged =
    resid ≤ tol``."""

    real: torch.Tensor           # [B, k]
    imag: torch.Tensor           # [B, k]
    vectors_real: torch.Tensor   # [B, n, k]
    vectors_imag: torch.Tensor   # [B, n, k]
    resid: torch.Tensor          # [B, k]
    converged: torch.Tensor      # [B, k] bool
    restarts: int                # restart cycles used


def _proj(U: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w − U Uᵀ w`` for ``U [B, n, m]``, ``w [B, n]``."""
    return w - (U @ (U.transpose(1, 2) @ w[:, :, None]))[:, :, 0]


@f32_matmuls()
def _expand(matvec, U, S, unext, j0: int, m: int, rnd: torch.Tensor):
    """Arnoldi steps ``j0 … m−1`` of the decomposition ``(U, S, u⁺)``;
    ``rnd [m, B, n]`` the splice draws of this restart.  Returns
    ``(U, S, u⁺, β)``."""
    U, S = U.clone(), S.clone()
    eps = torch.finfo(U.dtype).eps
    beta_eff = U.new_zeros(U.shape[0])
    zero = torch.zeros((), dtype=U.dtype, device=U.device)
    for j in range(j0, m):
        U[:, :, j] = unext
        w = matvec(unext)
        wnorm0 = torch.sqrt((w * w).sum(dim=1))
        # CGS2; unfilled basis columns are zero and add nothing
        h1 = (U.transpose(1, 2) @ w[:, :, None])[:, :, 0]
        w = w - (U @ h1[:, :, None])[:, :, 0]
        h2 = (U.transpose(1, 2) @ w[:, :, None])[:, :, 0]
        w = w - (U @ h2[:, :, None])[:, :, 0]
        beta = torch.sqrt((w * w).sum(dim=1))
        good = beta > 64.0 * eps * torch.clamp(wnorm0, min=1e-30)
        r = _proj(U, _proj(U, rnd[j]))
        rnorm = torch.clamp(torch.sqrt((r * r).sum(dim=1)), min=1e-30)
        unext = torch.where(good[:, None],
                            w / torch.clamp(beta, min=1e-30)[:, None],
                            r / rnorm[:, None])
        beta_eff = torch.where(good, beta, zero)
        S[:, :, j] = h1 + h2
        if j < m - 1:
            S[:, j + 1, j] = beta_eff
    return U, S, unext, beta_eff


@f32_matmuls()
def _contract(U, S, Yre, Yim, idx, use_im, slot_valid, beta):
    """The restart on the device: the kept real basis Y from the
    host-selected eigenvector slots, orthonormalized, and the Krylov
    decomposition projected onto it."""
    B, n, m = U.shape
    kp = idx.shape[1]
    cols_re = torch.take_along_dim(Yre, idx[:, None, :], dim=2)
    cols_im = torch.take_along_dim(Yim, idx[:, None, :], dim=2)
    Y = torch.where(use_im[:, None, :], cols_im, cols_re)
    Y = Y * slot_valid[:, None, :]
    Ypad = torch.cat([Y, Y.new_zeros(B, m, m - kp)], dim=2)
    gmask = torch.cat([slot_valid.bool(),
                       torch.zeros(B, m - kp, dtype=torch.bool,
                                   device=U.device)], dim=1)
    Q, _ = orthonormal_columns(Ypad, gmask)
    Y = Q[:, :, :kp]
    Snew = torch.zeros_like(S)
    Snew[:, :kp, :kp] = Y.transpose(1, 2) @ S @ Y
    # the coupling row: A (UY) = (UY)(YᵀSY) + u⁺ (β eₘᵀ Y)
    Snew[:, kp, :kp] = beta[:, None] * Y[:, m - 1, :]
    Unew = torch.zeros_like(U)
    Unew[:, :, :kp] = U @ Y
    return Unew, Snew


def _select_host(re, im, valid, resid_est, dead, which, k, kp):
    """Per-lane greedy selection on the host: eigenvalue groups
    (conjugate pairs whole) ordered by the ``which`` key fill up to ``kp``
    slots.  Returns ``(idx, use_im, slot_valid)`` ``[B, kp]``."""
    B, m = re.shape
    mag = np.hypot(re, im)
    keys = {"LM": mag, "SM": -mag, "LR": re, "SR": -re}
    if which not in keys:
        raise ValueError(f"which={which!r} not in LM/SM/LR/SR")
    # Ritz columns on dead (decoupled zero) slots are never selected
    key = np.where(valid & ~dead, keys[which], -np.inf)
    idx = np.zeros((B, kp), np.int64)
    use_im = np.zeros((B, kp), bool)
    slot_valid = np.zeros((B, kp), bool)
    for b in range(B):
        groups = []
        j = 0
        while j < m:
            if im[b, j] != 0 and j + 1 < m and im[b, j + 1] != 0:
                groups.append((key[b, j], j, True))
                j += 2
            else:
                groups.append((key[b, j], j, False))
                j += 1
        groups.sort(key=lambda g: -g[0])
        s = 0
        for gkey, j, is_pair in groups:
            if not np.isfinite(gkey):
                continue
            need = 2 if is_pair else 1
            if s + need > kp:
                continue    # a smaller group may fit the last slot
            idx[b, s] = j
            slot_valid[b, s] = True
            if is_pair:
                idx[b, s + 1] = j
                use_im[b, s + 1] = True
                slot_valid[b, s + 1] = True
            s += need
            if s == kp:
                break
    return idx, use_im, slot_valid


def _host_pack(eig, beta, m: int):
    """The restart's host view in one device-to-host copy:
    ``(re, im, valid, ylast, beta, mass)`` as numpy arrays; counted in
    ``krylov.HOST_READS``."""
    B = beta.shape[0]
    vr, vi = eig.vectors_real, eig.vectors_imag
    pack = torch.cat([eig.real, eig.imag, eig.valid.to(eig.real.dtype),
                      beta[:, None], vr.reshape(B, -1), vi.reshape(B, -1)],
                     dim=1).cpu().numpy()
    krylov.HOST_READS += 1
    re, im = pack[:, :m], pack[:, m:2 * m]
    valid = pack[:, 2 * m:3 * m] != 0
    beta_h = pack[:, 3 * m]
    vr_h = pack[:, 3 * m + 1:3 * m + 1 + m * m].reshape(B, m, m)
    vi_h = pack[:, 3 * m + 1 + m * m:].reshape(B, m, m)
    ylast = np.sqrt(vr_h[:, m - 1, :] ** 2 + vi_h[:, m - 1, :] ** 2)
    return re, im, valid, ylast, beta_h, vr_h ** 2 + vi_h ** 2


def default_splice(B: int, n: int, m: int, dtype, device,
                   generator: Optional[torch.Generator] = None):
    """``splice(it)``: ``[m, B, n]`` standard normals a restart from a CPU
    generator (by default seeded ``SPLICE_SEED``), one copy each."""
    g = generator or torch.Generator().manual_seed(SPLICE_SEED)
    return lambda it: torch.randn(m, B, n, generator=g,
                                  dtype=dtype).to(device)


def eigs_arnoldi_matvec(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    k: int,
    which: str = "LM",
    m: Optional[int] = None,
    tol: Optional[float] = None,
    max_restarts: int = 30,
    splice: Optional[Callable[[int], torch.Tensor]] = None,
) -> ArnoldiEigs:
    """``k`` exterior eigenpairs of the batched operator ``matvec``
    (``[B, n] → [B, n]``) by Krylov–Schur restarts.  ``v0 [B, n]`` seeds
    the Krylov space; ``m`` is the basis size (default ``max(2k+2, 16)``,
    at most n, at least k + 2); ``which`` ∈ LM/SM/LR/SR orders the Ritz
    values by magnitude or real part.  ``splice(it)`` gives restart
    ``it``'s breakdown directions (``default_splice`` otherwise)."""
    from .schur import eig_batched

    B, n = v0.shape
    dtype = torch.promote_types(v0.dtype, torch.float32)
    if m is None:
        m = max(2 * k + 2, 16)
    m = min(m, n)
    if m < k + 2:
        raise ValueError(f"basis m={m} must be ≥ k+2={k + 2} (n too small? "
                         f"use the dense ops.schur path)")
    kp = k + 1
    if tol is None:
        tol = 200.0 * torch.finfo(dtype).eps
    dev = v0.device
    splice = splice or default_splice(B, n, m, dtype, dev)

    v0 = v0.to(dtype)
    unext = v0 / torch.clamp(torch.sqrt((v0 * v0).sum(dim=1)),
                             min=1e-30)[:, None]
    U = torch.zeros(B, n, m, dtype=dtype, device=dev)
    S = torch.zeros(B, m, m, dtype=dtype, device=dev)
    j0 = 0
    dead = np.zeros((B, m), bool)
    restarts_used = max_restarts
    for it in range(max_restarts):
        U, S, unext, beta = _expand(matvec, U, S, unext, j0, m,
                                    splice(it).to(dtype))
        eig = eig_batched(S)
        re, im, valid, ylast, beta_h, mass = _host_pack(eig, beta, m)
        resid_est = beta_h[:, None] * ylast
        if dead.any():
            dead_ritz = (mass * dead[:, :, None]).sum(axis=1) > 0.5
        else:
            dead_ritz = np.zeros((B, m), bool)
        idx, use_im, slot_valid = _select_host(re, im, valid, resid_est,
                                               dead_ritz, which, k, kp)
        scale = np.maximum(np.abs(np.take_along_axis(
            np.hypot(re, im), idx, axis=1)).max(axis=1), 1e-30)
        sel_resid = np.take_along_axis(resid_est, idx, axis=1)
        done = ((sel_resid <= tol * scale[:, None]) | ~slot_valid).all()
        if done or it == max_restarts - 1:
            restarts_used = it + 1
            break
        U, S = _contract(
            U, S, eig.vectors_real, eig.vectors_imag,
            torch.from_numpy(idx).to(dev), torch.from_numpy(use_im).to(dev),
            torch.from_numpy(slot_valid).to(dtype).to(dev), beta)
        j0 = kp
        dead = np.zeros((B, m), bool)
        dead[:, :kp] = ~slot_valid

    Xre, Xim, lam_re, lam_im, resid = _extract(
        U, matvec, eig.vectors_real, eig.vectors_imag,
        torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev),
        torch.from_numpy(idx[:, :k]).to(dev),
        torch.from_numpy(use_im[:, :k]).to(dev))
    scale_j = torch.clamp(torch.hypot(lam_re, lam_im).amax(dim=1),
                          min=1e-30)
    conv = (resid <= tol * scale_j[:, None]) & torch.from_numpy(
        slot_valid[:, :k]).to(dev)
    return ArnoldiEigs(real=lam_re, imag=lam_im, vectors_real=Xre,
                       vectors_imag=Xim, resid=resid / scale_j[:, None],
                       converged=conv, restarts=restarts_used)


@f32_matmuls()
def _extract(U, matvec, Yre, Yim, re, im, idx, use_im):
    """Ritz vectors ``X = U y`` of the selected slots (a pair's ``+imag``
    member carries (re, im), its partner the conjugate) and their true
    residuals ‖Ax − λx‖ from one batched matvec a part."""
    yre = torch.take_along_dim(Yre, idx[:, None, :], dim=2)
    yim = torch.take_along_dim(Yim, idx[:, None, :], dim=2)
    yim = torch.where(use_im[:, None, :], -yim, yim)
    lam_re = torch.take_along_dim(re, idx, dim=1)
    lam_im0 = torch.take_along_dim(im, idx, dim=1).abs()
    lam_im = torch.where(use_im, -lam_im0, lam_im0)
    Xre, Xim = U @ yre, U @ yim
    nrm = torch.clamp(torch.sqrt((Xre * Xre + Xim * Xim).sum(dim=1)),
                      min=1e-30)[:, None, :]
    Xre, Xim = Xre / nrm, Xim / nrm
    k = idx.shape[1]
    Are = torch.stack([matvec(Xre[:, :, j]) for j in range(k)], dim=2)
    Aim = torch.stack([matvec(Xim[:, :, j]) for j in range(k)], dim=2)
    lr, li = lam_re[:, None, :], lam_im[:, None, :]
    res_re = Are - (lr * Xre - li * Xim)
    res_im = Aim - (lr * Xim + li * Xre)
    resid = torch.sqrt((res_re * res_re + res_im * res_im).sum(dim=1))
    return Xre, Xim, lam_re, lam_im, resid


def _default_v0(B: int, n: int, dtype, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(V0_SEED)
    return torch.randn(B, n, generator=g, dtype=dtype).to(device)


def eigs_arnoldi_batched(
    a: torch.Tensor, k: int, which: str = "LM", m: Optional[int] = None,
    tol: Optional[float] = None, max_restarts: int = 30,
    v0: Optional[torch.Tensor] = None,
    splice: Optional[Callable[[int], torch.Tensor]] = None,
) -> ArnoldiEigs:
    """``eigs_arnoldi_matvec`` on dense ``a [B, n, n]`` (``matvec = a @
    v``); ``v0`` by default a seeded draw (``V0_SEED``)."""
    B, n, _ = a.shape
    dtype = torch.promote_types(a.dtype, torch.float32)

    def matvec(v):
        with f32_matmuls():
            return (a @ v[:, :, None])[:, :, 0]

    if v0 is None:
        v0 = _default_v0(B, n, dtype, a.device)
    return eigs_arnoldi_matvec(matvec, v0, k, which=which, m=m, tol=tol,
                               max_restarts=max_restarts, splice=splice)


def _lu_solver(fac):
    """``v ↦ (PA)⁻¹ P v`` on ``ops.lu``'s packed factors by the library's
    triangular solves (the row-at-a-time ``lu_solve_batched`` would take
    2n launches a product)."""
    lu, perm = fac.lu, fac.perm.long()

    def solve(v):
        pv = torch.take_along_dim(v, perm, dim=1)[:, :, None]
        with f32_matmuls():
            y = torch.linalg.solve_triangular(lu, pv, upper=False,
                                              unitriangular=True)
            return torch.linalg.solve_triangular(lu, y, upper=True)[:, :, 0]

    return solve


def eigs_arnoldi_shifted_batched(
    a: torch.Tensor, k: int, sigma: float, m: Optional[int] = None,
    tol: Optional[float] = None, max_restarts: int = 30,
    v0: Optional[torch.Tensor] = None,
    splice: Optional[Callable[[int], torch.Tensor]] = None,
) -> ArnoldiEigs:
    """The ``k`` eigenvalues of ``a`` closest to ``σ`` by shift-invert
    Arnoldi: one pivoted LU of ``A − σI`` (``ops.lu``'s loop), Krylov–Schur
    on ``(A − σI)⁻¹``, whose LM Ritz values μ map back through
    ``λ = σ + 1/μ``.  ``resid`` / ``converged`` are recomputed against A
    itself."""
    from .lu import lu_factor_batched

    B, n, _ = a.shape
    dtype = torch.promote_types(a.dtype, torch.float32)
    a = a.to(dtype)
    eye = torch.eye(n, dtype=dtype, device=a.device)
    fac = lu_factor_batched(a - sigma * eye)
    if v0 is None:
        v0 = _default_v0(B, n, dtype, a.device)
    res = eigs_arnoldi_matvec(_lu_solver(fac), v0, k, which="LM", m=m,
                              tol=tol, max_restarts=max_restarts,
                              splice=splice)
    if tol is None:
        tol = 200.0 * torch.finfo(dtype).eps
    mu_re, mu_im = res.real, res.imag
    mu2 = torch.clamp(mu_re * mu_re + mu_im * mu_im, min=1e-38)
    lam_re = sigma + mu_re / mu2
    lam_im = -mu_im / mu2
    with f32_matmuls():
        Ar, Ai = a @ res.vectors_real, a @ res.vectors_imag
    lr, li = lam_re[:, None, :], lam_im[:, None, :]
    rr = Ar - (lr * res.vectors_real - li * res.vectors_imag)
    ri = Ai - (lr * res.vectors_imag + li * res.vectors_real)
    resid = torch.sqrt((rr * rr + ri * ri).sum(dim=1))
    scale = torch.clamp(a.abs().amax(dim=(1, 2)), min=1e-30)[:, None]
    return ArnoldiEigs(real=lam_re, imag=lam_im,
                       vectors_real=res.vectors_real,
                       vectors_imag=res.vectors_imag, resid=resid / scale,
                       converged=(resid <= tol * scale * n) & fac.ok[:, None],
                       restarts=res.restarts)
