"""Batched linear-system solving, nullspaces, inverses and rank
(counterpart of ``linalg_solver_tpu.ops.solve``).

Built on the Gauss–Jordan loop (``ops.rref``) and, for the affine solve
at its reach, on the pivoted kernel (``ops.kernels.gauss_jordan``).
Results of data-dependent size (solution-space dimension, rank) come
padded and masked: ``BatchedAffineSubspace`` is a particular solution
per system plus a padded ``[n, n]`` generator matrix whose ``gen_mask``
columns span the nullspace; ``is_consistent`` False means no solution.

The reference's one-hot matmul selects (``ops.select.take_rows_mxu``,
``_pivot_onehots``) are row gathers and scatters here
(``gauss_jordan.take_rows``, ``scatter_add``): on finite values both
are exact.  Per-matrix tolerances are ``[B]`` tensors wherever the
reference ``vmap``s a scalar.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels import gauss_jordan
from .kernels.gauss_jordan import take_rows
from .rref import RREFResult, Tol, batch_tol, rref_batched


class BatchedAffineSubspace(NamedTuple):
    """Padded affine solution set ``particular + span(generators[:, mask])``."""

    particular: torch.Tensor     # [..., n]
    generators: torch.Tensor     # [..., n, n]; gen_mask columns valid
    gen_mask: torch.Tensor       # [..., n] bool
    dim: torch.Tensor            # [...] int32
    is_consistent: torch.Tensor  # [...] bool; False: no solution

    def basis_list(self, b: Optional[int] = None):
        """The valid generator columns as a list of vectors (of a single
        solution set if ``b`` is None, else of system ``b``)."""
        gens = self.generators if b is None else self.generators[b]
        mask = self.gen_mask if b is None else self.gen_mask[b]
        return [gens[:, j] for j in range(gens.shape[1]) if bool(mask[j])]


class InverseResult(NamedTuple):
    inverse: torch.Tensor        # [..., n, n]
    is_invertible: torch.Tensor  # [...] bool


def _default_tol(aug: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The data-relative threshold ``100·max(m, n+1)·eps·max|[A|b]|`` per
    matrix of ``aug [B, ., .]``."""
    eps = torch.finfo(aug.dtype).eps
    return 100 * max(m, n + 1) * eps * aug.abs().amax(dim=(1, 2))


def _extract_affine(res: RREFResult, n: int, tol: torch.Tensor
                    ) -> BatchedAffineSubspace:
    """The padded affine solution sets of reduced ``[A | b]`` systems (bar
    at column n); ``tol [B]``."""
    R = res.reduced
    bsz = R.shape[0]
    k_max = res.pivot_rows.shape[-1]
    valid = torch.arange(k_max, device=R.device)[None, :] < \
        res.num_pivots[:, None]
    prow = res.pivot_rows.long().clamp(min=0)
    pcol = res.pivot_cols.long().clamp(min=0)
    vf = valid.to(R.dtype)
    # pivot k's row of R, zero for padded pivots
    rows_k = take_rows(R, prow) * vf[:, :, None]              # [B, k, n+1]
    pivot_cols = torch.zeros(bsz, n, dtype=R.dtype, device=R.device
                             ).scatter_add(1, pcol, vf)
    free_f = 1 - pivot_cols
    free = free_f > 0.5
    rhs = R[:, :, n]
    # particular[c_k] = rhs[r_k]
    particular = torch.zeros(bsz, n, dtype=R.dtype, device=R.device
                             ).scatter_add(1, pcol, rows_k[:, :, n])
    # g_j = e_j − Σ_k e_{c_k} R[r_k, j] on the free columns j
    correction = torch.zeros(bsz, n, n, dtype=R.dtype, device=R.device
                             ).scatter_add(
        1, pcol[:, :, None].expand(-1, -1, n), rows_k[:, :, :n])
    eye = torch.eye(n, dtype=R.dtype, device=R.device)
    generators = (eye - correction) * free_f[:, None, :]
    # consistency: no row zero on the left but not at the bar
    left_zero = (R[:, :, :n].abs() <= tol[:, None, None]).all(dim=2)
    inconsistent = (left_zero & (rhs.abs() > tol[:, None])).any(dim=1)
    return BatchedAffineSubspace(
        particular=particular, generators=generators, gen_mask=free,
        dim=free.sum(dim=1).to(torch.int32), is_consistent=~inconsistent)


def solve_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    tol: Optional[Tol] = None,
    pivot_rule: str = "first",
) -> BatchedAffineSubspace:
    """Solution sets of ``a @ x = b`` for ``a [B, m, n]``, ``b [B, m]``.
    ``tol`` is one threshold, one per matrix ``[B]``, or None for the
    data-relative ``100·max(m, n+1)·eps·max|[A|b]|`` of each system; pass
    0 for exact semantics on integer data."""
    bsz, m, n = a.shape
    dt = torch.promote_types(a.dtype, torch.float32)
    aug = torch.cat([a.to(dt), b.reshape(bsz, m, 1).to(dt)], dim=2)
    tol = (_default_tol(aug, m, n) if tol is None
           else batch_tol(tol, bsz, dt, a.device))
    res = rref_batched(aug, bar_col=n, tol=tol, pivot_rule=pivot_rule,
                       record_events=False)
    return _extract_affine(res, n, tol)


def solve(a: torch.Tensor, b: torch.Tensor, tol: Optional[float] = None,
          pivot_rule: str = "first") -> BatchedAffineSubspace:
    """Solution set of a single ``[m, n]`` system."""
    res = solve_batched(a[None], b[None], tol=tol, pivot_rule=pivot_rule)
    return BatchedAffineSubspace(*(t[0] for t in res))


def nullspace_batched(a: torch.Tensor, tol: Optional[Tol] = None,
                      pivot_rule: str = "first") -> BatchedAffineSubspace:
    """Kernels of ``a [B, m, n]`` as affine subspaces through the origin."""
    b = torch.zeros(a.shape[0], a.shape[1], dtype=a.dtype, device=a.device)
    return solve_batched(a, b, tol=tol, pivot_rule=pivot_rule)


def nullspace(a: torch.Tensor, tol: Optional[float] = None,
              pivot_rule: str = "first") -> BatchedAffineSubspace:
    return BatchedAffineSubspace(*(t[0] for t in nullspace_batched(
        a[None], tol=tol, pivot_rule=pivot_rule)))


def inverse_batched(a: torch.Tensor, tol: Tol = 0.0,
                    pivot_rule: str = "partial") -> InverseResult:
    """Inverses by Gauss–Jordan on ``[A | I]``; a matrix with fewer than n
    pivots comes back NaN and not ``is_invertible``."""
    bsz, n, _ = a.shape
    dt = torch.promote_types(a.dtype, torch.float32)
    eye = torch.eye(n, dtype=dt, device=a.device).expand(bsz, n, n)
    res = rref_batched(torch.cat([a.to(dt), eye], dim=2), bar_col=n,
                       tol=tol, pivot_rule=pivot_rule, record_events=False)
    inv = res.reduced[:, :, n:]
    ok = res.num_pivots == n
    return InverseResult(
        torch.where(ok[:, None, None], inv, torch.full_like(inv, torch.nan)),
        ok)


def inverse(a: torch.Tensor, tol: float = 0.0,
            pivot_rule: str = "partial") -> InverseResult:
    return InverseResult(*(t[0] for t in inverse_batched(
        a[None], tol=tol, pivot_rule=pivot_rule)))


def rank_batched(a: torch.Tensor, tol: Optional[Tol] = None,
                 pivot_rule: str = "partial") -> torch.Tensor:
    """Numerical ranks (int32): the pivots Gauss–Jordan finds above ``tol``
    (one threshold, one per matrix, or None for
    ``gauss_jordan.default_rank_tol``: 100x the usual
    ``max(m, n)·eps·max|a|``, as Gauss–Jordan residues exceed an SVD's)."""
    bsz = a.shape[0]
    a32 = a.to(torch.promote_types(a.dtype, torch.float32))
    tol = (gauss_jordan.default_rank_tol(a32) if tol is None
           else batch_tol(tol, bsz, a32.dtype, a.device))
    res = rref_batched(a32, bar_col=a.shape[-1], tol=tol,
                       pivot_rule=pivot_rule, record_events=False)
    return res.num_pivots


def rank(a: torch.Tensor, tol: Optional[float] = None,
         pivot_rule: str = "partial") -> torch.Tensor:
    return rank_batched(a[None], tol=tol, pivot_rule=pivot_rule)[0]


def det_gj_batched(a: torch.Tensor, tol: Tol = 0.0,
                   pivot_rule: str = "partial") -> torch.Tensor:
    """Determinants as a by-product of Gauss–Jordan (sign × pivot
    product); the faster path is ``ops.lu.det_lu_batched``."""
    return rref_batched(a, bar_col=a.shape[-1], tol=tol,
                        pivot_rule=pivot_rule, record_events=False).det


def det_gj(a: torch.Tensor, tol: float = 0.0,
           pivot_rule: str = "partial") -> torch.Tensor:
    return det_gj_batched(a[None], tol=tol, pivot_rule=pivot_rule)[0]


# --- the kernel side: square-padded [A | b] through kernel 3 -----------


def augment_square_padded(a: torch.Tensor, b: torch.Tensor,
                          tol: Optional[Tol]):
    """The square-padded augmented systems ``[B, s, s + 1]`` (``s =
    max(m, n)``; A's columns, zeros to s, then b; zero rows to s) and
    their ``[B]`` thresholds, by default the data-relative
    ``100·max(m, n+1)·eps·max|[A|b]|``.  The kernel path and the blocked
    path build identical systems and thresholds, so the size-based route
    between them never changes a rank decision."""
    bsz, m, n = a.shape
    s = max(m, n)
    dt = torch.promote_types(a.dtype, torch.float32)
    aug = torch.zeros(bsz, s, s + 1, dtype=dt, device=a.device)
    aug[:, :m, :n] = a.to(dt)
    aug[:, :m, s] = b.to(dt)
    tol = (_default_tol(aug, m, n) if tol is None
           else batch_tol(tol, bsz, dt, a.device))
    return aug, tol


def _extract_from_rref(R: torch.Tensor, perm: torch.Tensor,
                       pivs: torch.Tensor, n: int, tol: torch.Tensor
                       ) -> BatchedAffineSubspace:
    """The affine solution sets from a square-padded RREF triple: ``R [B,
    s, s + 1]`` reduced in place (last column the RHS), ``perm [B, s]``
    the physical row of each column step's pivot, ``pivs [B, s]`` the
    pivot values (0: column skipped).  Kernel 3 and the blocked RREF both
    emit this contract; the pivot column of step k is k."""
    bsz, s, _ = R.shape
    dt = R.dtype
    col_mask = (pivs != 0).to(dt)                        # [B, s]
    Rp = take_rows(R, perm)                              # rows in pivot order
    particular = (Rp[:, :, s] * col_mask)[:, :n]
    # g_j = e_j − Σ_k e_k · Rp[k, j] on the free columns j < n
    correction = col_mask[:, :, None] * Rp[:, :, :s]
    gen_all = torch.eye(s, dtype=dt, device=R.device)[None] - correction
    free_f = (1 - col_mask)[:, :n]
    generators = gen_all[:, :n, :n] * free_f[:, None, :]
    # consistency: a physical row with a zero left side but not at the bar
    pivot_row_mask = torch.zeros(bsz, s, dtype=dt, device=R.device
                                 ).scatter_add(1, perm.long(), col_mask)
    left_zero = (R[:, :, :s].abs() <= tol[:, None, None]).all(dim=2)
    inconsistent = ((pivot_row_mask == 0) & left_zero
                    & (R[:, :, s].abs() > tol[:, None])).any(dim=1)
    return BatchedAffineSubspace(
        particular=particular, generators=generators, gen_mask=free_f > 0.5,
        dim=free_f.sum(dim=1).to(torch.int32), is_consistent=~inconsistent)


def solve_affine_gj_supported(m: int, n: int) -> bool:
    """Whether kernel 3 takes the square-padded ``[s, s + 1]`` system
    (``s = max(m, n)``) in its big reach (``gauss_jordan.fits_big``, the
    reference's big VMEM budget: s ≤ 423)."""
    s = max(m, n)
    return gauss_jordan.fits_big(s, s + 1)


def solve_affine_gj_batched(
    a: torch.Tensor, b: torch.Tensor, tol: Optional[Tol] = None
) -> BatchedAffineSubspace:
    """Affine solution sets of a whole batch through kernel 3 (on a CPU
    tensor its plain version): the square-padded ``[A | b]``, one launch,
    then the extraction.  The same sets as ``solve_batched(...,
    pivot_rule="partial")``: the in-place kernel considers the same pivot
    candidates, and the reduced row echelon form is unique for a given
    set of pivot columns.  ``a [B, m, n]``, ``b [B, m]``; ``tol`` per
    matrix ``[B]`` or None (data-relative)."""
    n = a.shape[2]
    aug, tol = augment_square_padded(a, b, tol)
    res = gauss_jordan.gauss_jordan_tiled(aug, tol)
    return _extract_from_rref(res.reduced, res.perm, res.pivots, n, tol)
