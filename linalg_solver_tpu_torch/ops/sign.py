"""Batched matrix sign function and spectral counting (counterpart of
``linalg_solver_tpu.ops.sign``).

``sign(A)`` (Roberts) maps every eigenvalue to ±1 by the sign of its real
part while keeping the invariant subspaces.  From it come eigenvalue
counts in half-planes and spectral projectors, with only inverses and
products (no QR iteration): every step of the scaled Newton iteration

    X ← (μX + (μX)⁻¹) / 2,   μ = |det X|^{-1/n}   (determinantal scaling)

is one batched inverse and elementwise work, quadratically convergent.
It needs no eigenvalue on the imaginary axis (the function is not
defined there); lanes that do not converge are flagged.

``eig_count_left_batched`` counts the eigenvalues with Re λ < σ as
``(n − tr sign(A − σI))/2`` without computing them.

The reference's ``while_loop`` stops when every lane is done; here the
host reads that flag once a step (one step is an inverse and a
log-determinant), so ``iters`` is the reference's.  A done lane keeps its
X bitwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .schur import _f32


class SignResult(NamedTuple):
    S: torch.Tensor          # [B, n, n] with S² ≈ I
    converged: torch.Tensor  # [B] ‖S² − I‖ below tolerance
    iters: torch.Tensor      # [] i32 — Newton steps executed


def inv_or_nan(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.inv``: the inverse of every matrix, NaN where the LU
    meets a zero pivot (``torch.linalg.inv`` would raise)."""
    inv, info = torch.linalg.inv_ex(x)
    return torch.where((info != 0)[:, None, None], torch.nan, inv)


@f32_matmuls()
def sign_batched(a: torch.Tensor, max_iters: int = 40) -> SignResult:
    """Matrix sign of a batched real matrix with no eigenvalues on the
    imaginary axis."""
    B, n, _ = a.shape
    X = _f32(a)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    tol = 64.0 * n * torch.finfo(X.dtype).eps

    def err(X):
        return (X @ X - eye).abs().amax((1, 2))

    done = err(X) <= tol
    k = 0
    while k < max_iters and not bool(done.all()):
        # determinantal scaling accelerates the pre-asymptotic phase
        _, logabs = torch.linalg.slogdet(X)
        mu = torch.exp(-logabs / n)
        mu = torch.where(torch.isfinite(mu) & (mu > 0), mu, 1.0)
        Xs = mu[:, None, None] * X
        X_new = 0.5 * (Xs + inv_or_nan(Xs))
        # freeze converged lanes (further steps only stir roundoff)
        X = torch.where(done[:, None, None], X, X_new)
        done = err(X) <= tol
        k += 1
    return SignResult(X, done, torch.tensor(k, dtype=torch.int32,
                                            device=X.device))


def eig_count_left_batched(a: torch.Tensor, sigma: float = 0.0,
                           max_iters: int = 40):
    """[B] number of eigenvalues with ``Re λ < sigma`` a lane (and the
    converged mask): spectrum bisection without eigensolving."""
    n = a.shape[-1]
    a = _f32(a)
    shifted = a - sigma * torch.eye(n, dtype=a.dtype, device=a.device)
    res = sign_batched(shifted, max_iters=max_iters)
    tr = res.S.diagonal(dim1=1, dim2=2).sum(-1)
    count = torch.round((n - tr) / 2.0).to(torch.int32)
    return count, res.converged


def spectral_projector_batched(a: torch.Tensor, sigma: float = 0.0,
                               max_iters: int = 40):
    """Spectral projector ``P = (I − sign(A − σI))/2`` onto the invariant
    subspace of the eigenvalues with ``Re λ < σ`` (P² = P, PA = AP; its
    rank is the eigenvalue count).  Returns ``(P, converged)``."""
    n = a.shape[-1]
    a = _f32(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    res = sign_batched(a - sigma * eye, max_iters=max_iters)
    return 0.5 * (eye[None] - res.S), res.converged
