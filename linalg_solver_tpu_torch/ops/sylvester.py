"""Batched Sylvester, Lyapunov and Stein equations (counterpart of
``linalg_solver_tpu.ops.sylvester``).

Solves ``A X + X B = C`` for batches of dense real systems, built from
the eigensolver stack:

1. ``A = M T M⁻¹``: the real Schur form with accumulated vectors
   (``ops.schur.real_schur_vectors``; M = diag(scale)⁻¹·Q, the balance
   similarity being ``A_b = D A D⁻¹``);
2. ``B = W Λ W⁻¹``: the complex eigendecomposition of B
   (``ops.schur.eig_batched``);
3. in the transformed bases the columns decouple,
   ``(T + λⱼI) zⱼ = (M⁻¹ C W)ⱼ``: m shifted quasi-triangular solves, all
   columns at once through the inverse-iteration back-substitution
   (``ops.schur._shifted_backsolve``); then ``X = M Z W⁻¹``.

This is the eigendecomposition variant of Bartels–Stewart: B must be
diagonalizable with a reasonably conditioned eigenbasis (κ(W) enters the
error; a defective B needs the fully quasi-triangular substitution, not
implemented).  Solvability needs spec(A) ∩ spec(−B) = ∅; near violations
are held off by the back-substitution's pivot floor and show as large
residuals.  ``ok`` flags lanes whose eigensolves converged and gave a
full valid eigenbasis.

``stein_batched`` solves ``A X Aᵀ − X + Q = 0`` by Smith's doubling; the
reference's ``while_loop`` stops when every lane is done or failed, and
here the host reads that flag once a step, so ``iters`` is the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .schur import (_f32, _shifted_backsolve, eig_batched,
                    real_schur_vectors)


class SylvesterResult(NamedTuple):
    X: torch.Tensor            # [B, n, m] real solution
    ok: torch.Tensor           # [B] both eigensolves clean + basis valid
    imag_defect: torch.Tensor  # [B] max |Im X| / max |Re X|: roundoff for
    #                            real data; large on an ill-posed or
    #                            defective lane


def solve_or_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.solve``: ``a⁻¹ b`` for every system, NaN where the LU
    meets a zero pivot (``torch.linalg.solve`` would raise)."""
    x, info = torch.linalg.solve_ex(a, b)
    return torch.where((info != 0)[:, None, None], torch.nan, x)


@f32_matmuls()
def _assemble(scale, Q, T, c, eg_re, eg_im, W_re, W_im):
    # A = M T M⁻¹ with M = D⁻¹Q, D = diag(scale) (eig_batched divides its
    # eigenvectors by ``scale`` the same way); F = M⁻¹ C W = Qᵀ (D C) W
    F0 = Q.transpose(1, 2) @ (c * scale[:, :, None])
    F_re, F_im = F0 @ W_re, F0 @ W_im
    # (T + λⱼ I) zⱼ = Fⱼ  ⇔  (T − (−λⱼ) I) zⱼ = Fⱼ
    Z_re, Z_im = _shifted_backsolve(T, -eg_re, -eg_im, F_re, F_im)
    # X = M Z W⁻¹, W⁻¹ applied in complex (X W = Z ⇒ Wᵀ Xᵀ = Zᵀ)
    W = torch.complex(W_re, W_im)
    Z = torch.complex(Z_re, Z_im)
    Xc = solve_or_nan(W.transpose(1, 2), Z.transpose(1, 2)).transpose(1, 2)
    Xc = (Q.to(Xc.dtype) @ Xc) / scale[:, :, None]
    re_max = Xc.real.abs().amax((1, 2))
    im_max = Xc.imag.abs().amax((1, 2))
    return Xc.real.contiguous(), im_max / re_max.clamp(min=1e-30)


def sylvester_batched(a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor) -> SylvesterResult:
    """Solve ``a @ X + X @ b = c`` a lane (``a [B,n,n]``, ``b [B,m,m]``,
    ``c [B,n,m]``)."""
    a, b, c = _f32(a), _f32(b), _f32(c)
    sv = real_schur_vectors(a)
    eg = eig_batched(b)
    X, defect = _assemble(sv.scale, sv.Q, sv.T, c, eg.real, eg.imag,
                          eg.vectors_real, eg.vectors_imag)
    ok = (sv.converged & eg.converged & eg.valid.all(1)
          & torch.isfinite(X).all(dim=(1, 2)))
    return SylvesterResult(X, ok, defect)


def lyapunov_batched(a: torch.Tensor, q: torch.Tensor) -> SylvesterResult:
    """Solve the continuous Lyapunov equation ``a X + X aᵀ = q``."""
    return sylvester_batched(a, a.transpose(1, 2), q)


class SteinResult(NamedTuple):
    """``X`` solves ``A X Aᵀ − X + Q = 0`` where ``ok``; lanes whose
    spectral radius is not < 1 (the solvability condition) diverge the
    doubling iteration and report ``ok=False``."""

    X: torch.Tensor      # [B, n, n]
    ok: torch.Tensor     # [B]
    iters: torch.Tensor  # [] i32


@f32_matmuls()
def stein_batched(a: torch.Tensor, q: torch.Tensor,
                  max_iters: int = 30) -> SteinResult:
    """Discrete Lyapunov (Stein) equation ``A X Aᵀ − X + Q = 0`` by Smith
    doubling: with ``ρ(A) < 1``, ``X = Σ_k Aᵏ Q (Aᵀ)ᵏ`` and the partial
    sums double a step (``X ← X + P X Pᵀ; P ← P²``), two products a
    step.  Divergence (ρ ≥ 1) is seen a lane from the growth of ‖P‖ and
    flagged."""
    a, q = _f32(a), _f32(q)
    B = a.shape[0]
    eps = torch.finfo(a.dtype).eps

    def nrm(x):
        return x.abs().amax((1, 2))

    p_scale0 = nrm(a).clamp(min=1e-30)
    X, P = q, a
    done = torch.zeros(B, dtype=torch.bool, device=a.device)
    ok = torch.ones(B, dtype=torch.bool, device=a.device)
    k = 0
    while k < max_iters and not bool((done | ~ok).all()):
        upd = (P @ X) @ P.transpose(1, 2)
        X_new = X + upd
        P_new = P @ P
        step = nrm(upd) / nrm(X_new).clamp(min=1e-30)
        done_new = step < 4.0 * eps
        # ρ(A) ≥ 1 ⇒ ‖P‖ = ‖A^{2^k}‖ grows past any polynomial factor
        ok_new = (ok & (nrm(P_new) < 1e6 * p_scale0)
                  & torch.isfinite(X_new).all(dim=(1, 2)))
        upd_mask = (~done & ok)[:, None, None]
        X = torch.where(upd_mask, X_new, X)
        P = torch.where(upd_mask, P_new, P)
        done, ok = done | done_new, ok_new
        k += 1
    X = 0.5 * (X + X.transpose(1, 2))
    return SteinResult(X, ok & done, torch.tensor(k, dtype=torch.int32,
                                                  device=a.device))
