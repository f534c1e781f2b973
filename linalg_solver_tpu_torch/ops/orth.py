"""Batched orthonormalization of masked column sets (counterpart of
``linalg_solver_tpu.ops.orth``).

Shifted CholeskyQR3 over front-compacted columns: batched Gram products,
a batched Cholesky and triangular solves, no per-column Householder
loop.  The spectral and Jordan pipelines orthonormalize Gauss–Jordan
nullspace generators with it (raw RREF generators are independent but
far from orthogonal, and at 256-dimensional eigenspaces they push
``κ(P)`` past what the f32 ``P·P⁻¹`` validation accepts).

The reference's one-hot compaction matmul is an index scatter here: each
masked column lands where the reference puts it, in the same order.
``jnp.linalg.cholesky`` returns NaN for a Gram matrix that is not
positive definite: ``_chol_qr`` factors with ``ops.spd.cholesky_or_nan``,
so a failed basis is non-finite in the same lanes as the reference's.
"""

from __future__ import annotations

import torch

from ..utils.precision import f32_matmuls
from .spd import cholesky_or_nan


def compact_columns(gens: torch.Tensor, gmask: torch.Tensor) -> torch.Tensor:
    """Move the masked columns of ``gens [B, n, n]`` to the front (order
    kept), zeros elsewhere; ``gmask [B, n]`` bool."""
    bsz, n, _ = gens.shape
    # destination of column j: its rank among the masked columns; the
    # unmasked ones go to a spare column n that is dropped
    dest = torch.where(gmask, torch.cumsum(gmask, dim=1) - 1,
                       torch.full_like(gmask, n, dtype=torch.long))
    out = torch.zeros(bsz, n, n + 1, dtype=gens.dtype, device=gens.device)
    out.scatter_(2, dest[:, None, :].expand(bsz, n, n), gens)
    return out[:, :, :n]


def _right_tri_solve(g: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Solve ``Q Lᵀ = G`` for Q with L lower-triangular: Qᵀ = L⁻¹ Gᵀ."""
    qt = torch.linalg.solve_triangular(L, g.transpose(-1, -2), upper=False)
    return qt.transpose(-1, -2)


def _chol_qr(g: torch.Tensor, colmask: torch.Tensor, shift: float = 0.0):
    """One CholeskyQR pass on front-compacted columns; masked-out columns
    stay exactly zero (their Gram diagonal is patched to 1).  ``shift``
    adds a relative diagonal regularization (shifted CholeskyQR).  A
    Gram matrix that is not positive definite gives a NaN factor for its
    whole lane, as the reference's Cholesky does."""
    nc = g.shape[-1]
    eye = torch.eye(nc, dtype=g.dtype, device=g.device)
    with f32_matmuls():
        gram = g.transpose(-1, -2) @ g
    if shift:
        scale = gram.diagonal(dim1=1, dim2=2).sum(dim=1)[:, None, None]
        gram = gram + shift * scale * eye
    gram = gram + (1.0 - colmask[:, None, :]) * eye
    Q = _right_tri_solve(g, cholesky_or_nan(gram))
    return Q * colmask[:, None, :]


def orthonormal_columns(gens: torch.Tensor, gmask: torch.Tensor):
    """Orthonormal basis of span(masked columns of gens), front-compacted:
    returns ``(Q [B, n, n], d [B])`` with the first ``d`` columns
    orthonormal and the rest exactly zero.

    Shifted CholeskyQR3: the columns are normalized, the first pass
    carries a diagonal shift that keeps the Gram factorization positive
    definite for a normalized set conditioned past 1/√eps, and two
    unshifted passes restore orthonormality to working precision."""
    n = gens.shape[1]
    d = gmask.sum(dim=1).to(torch.int32)
    colmask = (torch.arange(n, device=gens.device)[None, :]
               < d[:, None]).to(gens.dtype)
    C = compact_columns(gens, gmask)
    norms = torch.sqrt((C * C).sum(dim=1))
    C = C / torch.clamp(norms, min=1e-30)[:, None, :]
    eps = torch.finfo(C.dtype).eps
    Q = _chol_qr(C, colmask, shift=16.0 * n * eps)
    Q = _chol_qr(Q, colmask)
    Q = _chol_qr(Q, colmask)
    return Q, d
