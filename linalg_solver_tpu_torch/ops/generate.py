"""Structured random matrix batches, generated on the device (counterpart
of ``linalg_solver_tpu.ops.generate``).

- unconstrained integer-valued batches,
- full rank by masked rejection (vectorized retries, no host loop),
- prescribed rank r as products of full-rank ``[m, r]`` and ``[r, n]``
  factors,
- diagonalizable with prescribed eigenvalues, ``P⁻¹ D P``,
- prescribed Jordan structure, ``P⁻¹ J P``,

with unimodular similarity transforms ``P = L·U`` (±1 diagonals, so
``P⁻¹`` is integer-valued) or, at large N, orthogonal ones.

Every function draws from an explicit ``torch.Generator`` that lives on
``device`` (by default the card).  The draws are torch's, not
``jax.random``'s: the same seed gives other matrices than the
reference's, with the same properties.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.precision import f32_matmuls
from .lu import det_lu_batched
from .solve import inverse_batched, rank_batched

Blocks = Sequence[Tuple[float, int]]


def _randint(gen, shape, lo, hi, dtype, device):
    return torch.randint(lo, hi + 1, shape, generator=gen,
                         device=device).to(dtype)


def _rejection(gen, shape, lo, hi, dtype, device, max_tries, good_fn):
    """Integer batches drawn until ``good_fn`` accepts each matrix: only
    the rejected ones are drawn again, ``max_tries`` rounds, no host
    read.  Returns the batch and the accepted mask."""
    out = torch.zeros(shape, dtype=dtype, device=device)
    ok = torch.zeros(shape[0], dtype=torch.bool, device=device)
    for _ in range(max_tries):
        cand = _randint(gen, shape, lo, hi, dtype, device)
        good = good_fn(cand)
        out = torch.where((~ok & good)[:, None, None], cand, out)
        ok = ok | good
    return out, ok


def random_batch(gen: torch.Generator, b: int, m: int, n: int,
                 lo: int = -5, hi: int = 5, dtype=torch.float32,
                 device="cuda") -> torch.Tensor:
    """iid integer entries in [lo, hi], shape ``[b, m, n]``."""
    return _randint(gen, (b, m, n), lo, hi, dtype, device)


def unimodular_batch(gen: torch.Generator, b: int, n: int,
                     dtype=torch.float32, spread: int = 1,
                     device="cuda") -> torch.Tensor:
    """``L @ U`` with ±1 diagonals: det = ±1, integer inverse."""
    sign_l = 2 * _randint(gen, (b, n), 0, 1, dtype, device) - 1
    sign_u = 2 * _randint(gen, (b, n), 0, 1, dtype, device) - 1
    L = torch.tril(_randint(gen, (b, n, n), -spread, spread, dtype, device),
                   -1) + torch.diag_embed(sign_l)
    U = torch.triu(_randint(gen, (b, n, n), -spread, spread, dtype, device),
                   1) + torch.diag_embed(sign_u)
    with f32_matmuls():
        return L @ U


def full_rank_batch(gen: torch.Generator, b: int, n: int,
                    lo: int = -5, hi: int = 5, dtype=torch.float32,
                    max_tries: int = 8, device="cuda") -> torch.Tensor:
    """Regular n×n batch by masked rejection: only the matrices whose
    determinant vanishes are drawn again (vectorized, no host read).  A
    matrix never drawn regular in ``max_tries`` rounds is the identity."""
    # integer determinants: nonzero means |det| >= 1
    out, ok = _rejection(gen, (b, n, n), lo, hi, dtype, device, max_tries,
                         lambda c: det_lu_batched(c).abs() > 0.5)
    eye = torch.eye(n, dtype=dtype, device=device)
    return torch.where(ok[:, None, None], out, eye)


def rank_batch(gen: torch.Generator, b: int, m: int, n: int, r: int,
               lo: int = -5, hi: int = 5, dtype=torch.float32,
               max_tries: int = 8, device="cuda") -> torch.Tensor:
    """Batch of m×n matrices of rank exactly r: products of
    full-column-rank ``[m, r]`` and full-row-rank ``[r, n]`` factors
    (masked rejection)."""
    def factor(rows, cols):
        return _rejection(gen, (b, rows, cols), lo, hi, dtype, device,
                          max_tries,
                          lambda c: rank_batched(c) == min(rows, cols))[0]

    A, B = factor(m, r), factor(r, n)
    with f32_matmuls():
        return A @ B


def orthogonal_batch(gen: torch.Generator, b: int, n: int,
                     dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Random orthogonal matrices (QR of a Gaussian), the sign of each
    column fixed so that Q is unique given the Gaussian (R's diagonal
    positive).  Perfectly conditioned similarity transforms: the right
    choice at large N, where unimodular inverses blow up."""
    g = torch.randn(b, n, n, generator=gen, dtype=dtype, device=device)
    with f32_matmuls():
        q, r = torch.linalg.qr(g)
    sign = torch.sign(r.diagonal(dim1=-2, dim2=-1))
    return q * sign[:, None, :]


def _similarity_pair(gen, b, n, transform, dtype, device):
    """(P_inv, P) for the requested transform family."""
    if transform == "orthogonal":
        P = orthogonal_batch(gen, b, n, dtype=dtype, device=device)
        return P.transpose(-1, -2), P
    P = unimodular_batch(gen, b, n, dtype=dtype, device=device)
    return inverse_batched(P, tol=1e-30).inverse, P


def diagonalizable_batch(gen: torch.Generator, b: int,
                         eigenvalues: Sequence[float], dtype=torch.float32,
                         transform: str = "unimodular",
                         device="cuda") -> torch.Tensor:
    """Diagonalizable batch with the prescribed (shared) eigenvalue list:
    ``P⁻¹ · diag(eigs) · P``.  ``transform="unimodular"`` (integer-exact,
    small N) or ``"orthogonal"`` (condition-preserving, any N)."""
    eigs = torch.as_tensor(eigenvalues, dtype=dtype, device=device)
    P_inv, P = _similarity_pair(gen, b, eigs.shape[0], transform, dtype,
                                device)
    with f32_matmuls():
        return P_inv @ torch.diag(eigs)[None] @ P


def jordan_form_matrix(blocks: List[Tuple[float, int]], dtype=torch.float32,
                       device="cuda") -> torch.Tensor:
    """The Jordan-form matrix for ``[(eigenvalue, size), ...]``."""
    n = sum(size for _, size in blocks)
    J = np.zeros((n, n), dtype=np.float64)
    pos = 0
    for eig, size in blocks:
        for i in range(size):
            J[pos + i, pos + i] = eig
            if i < size - 1:
                J[pos + i, pos + i + 1] = 1.0
        pos += size
    return torch.tensor(J, dtype=dtype, device=device)


def jordan_batch(gen: torch.Generator, b: int, blocks: Blocks,
                 dtype=torch.float32, transform: str = "unimodular",
                 device="cuda") -> torch.Tensor:
    """Batch of matrices similar to the prescribed Jordan form:
    ``P⁻¹ J P``.  Take ``transform="orthogonal"`` at large N (a
    unimodular P⁻¹ has exponentially large entries there)."""
    J = jordan_form_matrix(list(blocks), dtype, device=device)
    P_inv, P = _similarity_pair(gen, b, J.shape[0], transform, dtype,
                                device)
    with f32_matmuls():
        return P_inv @ J[None] @ P
