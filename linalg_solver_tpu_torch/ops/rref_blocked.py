"""Blocked rank-revealing Gauss–Jordan for large N (counterpart of
``linalg_solver_tpu.ops.rref_blocked``): the rank and the affine solve
past kernel 3's reach.

- **Panel eliminate** (``_panel_eliminate``): the nb column steps of a
  ``[B, n, nb]`` panel, batched: partial pivoting among the rows no
  earlier panel consumed, a column skipped where its best candidate is
  not above the matrix's ``tol`` (the rank-revealing part), and the
  fused all-rows update (entries above and below the pivot eliminated).
- **Trailing update**: the panel's composed row transform replayed on
  every other column with two products a side and one unit-lower
  triangular solve (``rref_blocked``'s comment says why that form).

The pivot-row selector ``S`` and the one-hot pivot reads of the
reference are row gathers and scatters here (exact on finite values).
Products run under ``f32_matmuls``, as the reference pins ``HIGHEST``.
The output triple (reduced, perm, pivots) is kernel 3's ``GJResult``
contract, so ``ops.solve._extract_from_rref`` serves both paths.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls
from .kernels.gauss_jordan import (_first_argmax, default_rank_tol, fms,
                                   take_rows)
from .rref import Tol, batch_tol
from .solve import _extract_from_rref, augment_square_padded


class BlockedRREF(NamedTuple):
    reduced: torch.Tensor  # [B, s, w] full RREF
    perm: torch.Tensor     # [B, s] int32 pivot row of each column step
    pivots: torch.Tensor   # [B, s] pivot values before normalising (0: skip)


def _scatter_rows(rows: torch.Tensor, idx: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """``Sᵀ rows``: ``[B, n, w]`` zeros with ``rows [B, p, w]`` added at the
    physical rows ``idx [B, p]``."""
    bsz, _, w = rows.shape
    out = torch.zeros(bsz, n, w, dtype=rows.dtype, device=rows.device)
    return out.scatter_add(1, idx[:, :, None].expand(-1, -1, w), rows)


def _panel_eliminate(panel: torch.Tensor, used: torch.Tensor,
                     tol: torch.Tensor):
    """Eliminate the nb columns of ``panel [B, n, nb]``: the pivot is the
    largest ``|value|`` among rows with ``used == 0``, a column whose
    best candidate is not above ``tol [B]`` is skipped, and each step
    eliminates the column from every other row.  Returns the reduced
    panel, the updated ``used``, the per-step coefficient vectors ``C
    [B, n, nb]`` (the trailing update replays them), and per column the
    pivot row and value (0 where skipped)."""
    bsz, n, nb = panel.shape
    dt, dev = panel.dtype, panel.device
    lanes = torch.arange(bsz, device=dev)
    rows = torch.arange(n, device=dev)
    C = torch.zeros(bsz, n, nb, dtype=dt, device=dev)
    perm_p = torch.zeros(bsz, nb, dtype=torch.int32, device=dev)
    pivs_p = torch.zeros(bsz, nb, dtype=dt, device=dev)
    for c in range(nb):
        col = panel[:, :, c]
        p = _first_argmax(torch.where(used > 0, -torch.inf, col.abs()))
        is_p = rows[None, :] == p[:, None]
        pivot_val = col[lanes, p]
        has = pivot_val.abs() > tol
        hasf = has.to(dt)
        inv = 1.0 / torch.where(has, pivot_val, 1.0)
        pivot_row = panel[lanes, p]                          # [B, nb]
        # eliminate with coefficient 0 at the pivot row, then write the
        # normalised pivot row as a product (the fused 1 − 1/piv form
        # loses ~eps·|piv| on the pivot row)
        coeff = torch.where(is_p, 0.0, col * inv[:, None]) * hasf[:, None]
        panel = fms(panel, coeff[:, :, None], pivot_row[:, None, :])
        norm_row = inv[:, None] * pivot_row
        panel = torch.where((is_p & has[:, None])[:, :, None],
                            norm_row[:, None, :], panel)
        used = torch.maximum(used, (is_p & has[:, None]).to(dt))
        C[:, :, c] = coeff
        perm_p[:, c] = p.to(torch.int32)
        pivs_p[:, c] = torch.where(has, pivot_val, 0.0)
    return panel, used, C, perm_p, pivs_p


@f32_matmuls()
def rref_blocked(a: torch.Tensor, tol: Optional[Tol] = None,
                 nb: int = 128) -> BlockedRREF:
    """Full RREF of ``a [B, s, w]`` (``w ≥ s``; the columns past s are the
    augmented part).  ``tol`` is the pivot threshold, one or one per
    matrix ``[B]`` (default 0)."""
    bsz, s, w = a.shape
    W = a.to(torch.promote_types(a.dtype, torch.float32))
    dt, dev = W.dtype, W.device
    tol = batch_tol(0.0 if tol is None else tol, bsz, dt, dev)
    used = torch.zeros(bsz, s, dtype=dt, device=dev)
    perm = torch.zeros(bsz, s, dtype=torch.int32, device=dev)
    pivs = torch.zeros(bsz, s, dtype=dt, device=dev)

    for j0 in range(0, s, nb):
        npanel = min(nb, s - j0)
        red_panel, used, C, perm_p, pivs_p = _panel_eliminate(
            W[:, :, j0:j0 + npanel], used, tol)
        take = (pivs_p != 0).to(dt)                          # [B, np]
        idx = perm_p.long()
        # The panel's transform replayed exactly: step c updated every
        # non-pivot row by coeff_c · Y_c and replaced row r_c by
        # inv_c · Y_c, Y_c the pivot row at its time of use:
        #     Y = L̃⁻¹ · S·T,   L̃ = I + tril(S·C, −1),
        # unit lower triangular with multipliers bounded by the partial
        # pivoting (solving through the panel's pivot block instead cost
        # ~eps·κ digits in the reference's measurements); the pivot rows
        # are then inv·Y − triu(S·C, 1)·Y, a clean product.
        SC = take_rows(C, idx) * take[:, :, None]            # S·C
        eye = torch.eye(npanel, dtype=dt, device=dev)
        Ltil = torch.tril(SC, -1) + eye
        inv_c = torch.where(
            take > 0, 1.0 / torch.where(pivs_p != 0, pivs_p, 1.0), 1.0)
        pivind = torch.zeros(bsz, s, dtype=dt, device=dev).scatter_add(
            1, idx, take)                                    # Sᵀ·1

        def update(block):
            if block.shape[2] == 0:
                return block
            T_rho = take_rows(block, idx) * take[:, :, None]  # S·T
            Y = torch.linalg.solve_triangular(Ltil, T_rho, upper=False,
                                              unitriangular=True)
            elim = block - C @ Y
            piv_rows = inv_c[:, :, None] * Y - torch.triu(SC, 1) @ Y
            return (elim * (1.0 - pivind)[:, :, None]
                    + _scatter_rows(piv_rows * take[:, :, None], idx, s))

        W = torch.cat([update(W[:, :, :j0]), red_panel,
                       update(W[:, :, j0 + npanel:])], dim=2)
        perm[:, j0:j0 + npanel] = perm_p
        pivs[:, j0:j0 + npanel] = pivs_p
    return BlockedRREF(W, perm, pivs)


def solve_affine_blocked_batched(
    a: torch.Tensor, b: torch.Tensor, tol: Optional[Tol] = None,
    nb: int = 128,
):
    """Large-N batched affine solve (singular or rectangular systems too):
    the square-padded ``[A | b]``, the blocked RREF, and kernel 3's
    extraction.  The same sets as ``solve.solve_batched(pivot_rule=
    "partial")``."""
    n = a.shape[2]
    aug, tol = augment_square_padded(a, b, tol)
    res = rref_blocked(aug, tol=tol, nb=min(nb, aug.shape[1]))
    return _extract_from_rref(res.reduced, res.perm, res.pivots, n, tol)


def rank_blocked_batched(a: torch.Tensor, tol: Optional[Tol] = None,
                         nb: int = 128) -> torch.Tensor:
    """Large-N batched numerical rank (int32) by counting the blocked
    RREF's pivots; rectangular input is square-padded with zeros, and the
    default ``tol`` is ``gauss_jordan.default_rank_tol``."""
    bsz, m, n = a.shape
    s = max(m, n)
    a32 = a.to(torch.promote_types(a.dtype, torch.float32))
    if m != n:
        sq = torch.zeros(bsz, s, s, dtype=a32.dtype, device=a.device)
        sq[:, :m, :n] = a32
        a32 = sq
    tol = default_rank_tol(a32) if tol is None else tol
    res = rref_blocked(a32, tol=tol, nb=min(nb, s))
    return (res.pivots.abs() > 0).sum(dim=-1).to(torch.int32)
