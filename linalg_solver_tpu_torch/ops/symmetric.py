"""Symmetric eigensolver path (counterpart of
``linalg_solver_tpu.ops.symmetric``).

Symmetric input gets the spectral theorem: orthogonal eigenvectors
(P⁻¹ = Pᵀ exactly, no inverse solve), every matrix diagonalizable, and
a direct solver that is faster and more accurate than a general
eigensolver.  ``eigh_batched`` is the library's batched
``torch.linalg.eigh`` (the reference calls XLA's, outside any Pallas
kernel), computed in float64 and rounded, with the reference's
backward; ``is_symmetric_batched`` is the
cheap structure probe ``spectral_pipeline(method="auto")`` routes by.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls


class EighResult(NamedTuple):
    """Ascending eigenvalues and orthonormal eigenvectors:
    ``a = V @ diag(w) @ Vᵀ``, column i of V pairs with w[:, i]."""

    w: torch.Tensor          # [B, n]
    V: torch.Tensor          # [B, n, n] orthogonal
    converged: torch.Tensor  # [B] (always True: a direct solver)


class _Eigh(torch.autograd.Function):
    """``eigh`` of ``(a + aᵀ)/2`` with the classical spectral adjoint
    ``Ā = V (diag(w̄) + F ∘ (Vᵀ V̄)) Vᵀ``, ``F_ij = 1/(w_j − w_i)``,
    symmetrized.  A pair closer than ``n·eps·‖w‖∞`` contributes zero
    instead of a 1/gap blow-up (torch's own backward divides by the
    gap): eigenvalue gradients stay exact, and an eigenvector gradient
    is defined only through its invariant subspace."""

    @staticmethod
    def forward(ctx, a):
        sym = (a + a.transpose(1, 2)) * 0.5
        # in float64, rounded back: the library's float32 eigh on an
        # H100 left eigenvalue errors of 6.7e-4 on 256x256 matrices of
        # norm 5 (LAPACK's float32 on the CPU: 4.8e-6), too coarse for
        # the spectral core's rank decisions on its eigenvalues
        w, V = torch.linalg.eigh(sym.to(torch.float64))
        w, V = w.to(a.dtype), V.to(a.dtype)
        ctx.save_for_backward(w, V)
        return w, V

    @staticmethod
    def backward(ctx, gw, gV):
        w, V = ctx.saved_tensors
        n = w.shape[-1]
        den = w[:, None, :] - w[:, :, None]          # den_ij = w_j − w_i
        tiny = n * torch.finfo(w.dtype).eps * torch.clamp(
            w.abs().amax(dim=-1), min=1e-30)[:, None, None]
        F = torch.where(den.abs() > tiny,
                        1.0 / torch.where(den == 0, 1.0, den), 0.0)
        F = F * (1.0 - torch.eye(n, dtype=w.dtype, device=w.device))
        with f32_matmuls():
            M = torch.diag_embed(gw) + F * (V.transpose(1, 2) @ gV)
            abar = V @ M @ V.transpose(1, 2)
        return 0.5 * (abar + abar.transpose(1, 2))


def eigh_batched(a: torch.Tensor) -> EighResult:
    """Eigendecomposition of a batch of SYMMETRIC real matrices ``a [B, n,
    n]``, symmetrized as ``(a + aᵀ)/2`` first (so numerically almost
    symmetric input, which the ``auto`` router admits, is well defined).
    Differentiable through ``_Eigh``, whose backward is finite on a
    repeated eigenvalue."""
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    w, V = _Eigh.apply(a)
    return EighResult(w, V, torch.ones(a.shape[0], dtype=torch.bool,
                                       device=a.device))


def symmetry_defect_batched(a: torch.Tensor) -> torch.Tensor:
    """``max|a − aᵀ| / max|a|`` per matrix: 0 for exactly symmetric."""
    skew = (a - a.transpose(1, 2)).abs().amax(dim=(1, 2))
    scale = torch.clamp(a.abs().amax(dim=(1, 2)), min=1e-30)
    return skew / scale


def is_symmetric_batched(a: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """[B] bool: relative symmetry defect ≤ tol."""
    return symmetry_defect_batched(a) <= tol
