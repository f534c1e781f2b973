"""Jordan-structure analysis of large matrix batches (counterpart of
``linalg_solver_tpu.models.jordan``; BASELINE config 5).

For each candidate eigenvalue λ, the Weyr characteristic
``w_k = dim ker (A−λI)^k − dim ker (A−λI)^{k−1}`` gives the Jordan
block structure: ``w_1`` is the geometric multiplicity (the number of
blocks), ``Σ_k w_k`` the algebraic multiplicity, ``w_k − w_{k+1}`` the
number of blocks of size exactly k.

The kernels of the powers come from the deflated (staircase) iteration

    ker M^{k+1} = ker((I − Q_k Q_kᵀ) M),   span Q_k = ker M^k,

so every matrix whose nullity is measured has norm ≤ ‖M‖ and the rank
threshold holds at every k (the powers themselves lose the signal like
gap^k).  The products run in full f32 (``f32_matmuls``), never TF32.

Nullspaces per step come from
- ``method="svd"``: ``torch.linalg.svd``; nullity by σ ≤ tol, Q the
  matching right singular vectors, or
- ``method="gj"``: ``dispatch.affine_solve_batched`` with the per-matrix
  tol (kernel 3 on the card, at n = 256 its variant 3) and the
  generators orthonormalized by shifted CholeskyQR.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.orth import compact_columns, orthonormal_columns
from ..utils.precision import f32_matmuls


class JordanReport(NamedTuple):
    weyr: torch.Tensor          # [B, E, k_max] Weyr characteristic per eigenvalue
    alg_mult: torch.Tensor      # [B, E]
    geom_mult: torch.Tensor     # [B, E]
    block_counts: torch.Tensor  # [B, E, k_max] Jordan blocks of size k


def _nullspace_svd(Bk: torch.Tensor, tol: torch.Tensor):
    """Nullity and orthonormal null basis from singular triplets;
    ``tol [S]`` absolute per matrix.  The null directions come last in
    singular order and are compacted to the front, as the gj path
    leaves them."""
    _, s, vh = torch.linalg.svd(Bk, full_matrices=True)
    nullmask = s <= tol[:, None]
    Q = vh.transpose(-1, -2) * nullmask[:, None, :].to(Bk.dtype)
    return compact_columns(Q, nullmask), nullmask.sum(dim=1).to(torch.int32)


def _nullspace_gj(Bk: torch.Tensor, tol: torch.Tensor):
    """Nullity and orthonormal null basis by Gauss–Jordan (kernel 3 on
    the card)."""
    from ..ops import dispatch

    zeros = torch.zeros(Bk.shape[:2], dtype=Bk.dtype, device=Bk.device)
    sub = dispatch.affine_solve_batched(Bk, zeros, tol=tol)
    return orthonormal_columns(sub.generators, sub.gen_mask)


def jordan_analysis(
    a: torch.Tensor,
    eigenvalues,
    k_max: int = 4,
    method: str = "gj",
    rel_tol: Optional[float] = None,
) -> JordanReport:
    """Weyr/Jordan structure of ``a [B, n, n]`` at each candidate
    eigenvalue (``eigenvalues [E]`` shared across the batch, or ``[B,
    E]``).

    ``rel_tol`` scales the nullity threshold relative to ``max|A−λI|``;
    the default ``100·n·eps`` absorbs the f32 formation error of
    similarity-transformed inputs, and the deflated iteration keeps it
    valid at every k."""
    if method not in ("svd", "gj"):
        raise ValueError(f"unknown rank method: {method!r}")
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    B, n, _ = a.shape
    lam = torch.as_tensor(eigenvalues, dtype=a.dtype, device=a.device)
    if lam.dim() == 1:
        lam = lam[None, :].expand(B, lam.shape[0])
    E = lam.shape[1]
    if rel_tol is None:
        rel_tol = 100 * n * torch.finfo(torch.float32).eps
    null_fn = _nullspace_gj if method == "gj" else _nullspace_svd

    # the eigenvalue axis folded into the batch: one [B·E] stack
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    M = a.repeat_interleave(E, dim=0) - lam.reshape(B * E)[:, None, None] * eye
    tol = rel_tol * M.abs().amax(dim=(1, 2))

    Q = torch.zeros_like(M)
    d_prev = torch.zeros(B * E, dtype=torch.int32, device=a.device)
    dims = []
    for _ in range(k_max):
        with f32_matmuls():
            Bk = M - Q @ (Q.transpose(1, 2) @ M)     # (I − Q Qᵀ) M
        Qn, d = null_fn(Bk, tol)
        # deflation never shrinks the kernel, and a failed (non-finite)
        # orthonormalization must not poison later steps: keep the
        # previous basis in either case
        keep = (d_prev >= d) | ~torch.isfinite(Qn).all(dim=2).all(dim=1)
        d_prev = torch.where(keep, d_prev, d)
        Q = torch.where(keep[:, None, None], Q, Qn)
        dims.append(d_prev)
    dims = torch.stack(dims, dim=1).reshape(B, E, k_max)
    prev = torch.cat([torch.zeros_like(dims[:, :, :1]), dims[:, :, :-1]],
                     dim=2)
    weyr = (dims - prev).to(torch.int32)
    nxt = torch.cat([weyr[:, :, 1:], torch.zeros_like(weyr[:, :, :1])],
                    dim=2)
    return JordanReport(weyr, weyr.sum(dim=-1, dtype=torch.int32),
                        weyr[:, :, 0], weyr - nxt)
