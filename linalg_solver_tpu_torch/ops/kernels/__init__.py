"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart of ``linalg_solver_tpu.ops.pallas``).

- ``solve_fused`` — the one-launch RBT solve
- ``inv_rbt`` — the fused RBT inverse with its in-kernel rescue
- ``gauss_jordan`` — pivoted Gauss–Jordan: inverse, solve, det, rank
- ``butterfly`` — the two-sided depth-≤2 butterfly in one pass (phase
  engine)
- ``lu_nopivot`` — panel LU without a pivot search (phase engine)
- ``lu_panel`` — partial-pivot panel LU without row swaps, skipping rows
  earlier panels pivoted (the pivoted phase loop of ``ops.lu_blocked``)
- ``schur_chase`` — one Francis sweep's bulge chase (``ops.schur``; no
  Pallas counterpart: the reference chases in an XLA scan)
- ``schur_window`` — an AED window's whole inner real Schur form
  (``ops.schur._aed``; no Pallas counterpart: the reference runs an XLA
  while loop)
- ``trsyl`` — the masked triangular Sylvester solve of the cluster
  condition numbers (``ops.ordschur``; no Pallas counterpart: the
  reference runs a nested XLA scan)
- ``sturm`` — the Sturm-count bisection of the tridiagonal eigenvalues
  (``ops.sturm``; no Pallas counterpart: the reference runs an XLA while
  loop around a scan)
- ``complex_gauss`` — the pivoted complex Gauss elimination of the
  complex determinant (``ops.complexlin``; no Pallas counterpart: the
  reference runs an XLA fori loop)

The functions below are the facade ``ops.dispatch`` routes to, as the
JAX package's ``ops.pallas`` is: ``inverse_batched`` takes the fused RBT
inverse where it reaches (N % 4 = 0 to 180, the reference's
``inv_rbt_kernel.supported``) and the pivoted kernel elsewhere (to
N = 167); solve and det run on the pivoted kernel in a block's shared
memory (to N = 236 and 237), and the rank on it to N = 424, past 237 in
a thread-block cluster's shared memory (the reference gives the rank its
big VMEM budget, having no blocked rank-revealing alternative below
256).  Past the kernels'
reach they raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import gauss_jordan, inv_rbt

#: augmented width the pivoted kernel needs per op
_WIDTH = {
    "inverse": lambda n: 2 * n,
    "solve": lambda n: n + 1,
    "det": lambda n: n,
    "rank": lambda n: n,
}


def supports(op: str, n: int) -> bool:
    """Whether a kernel takes ``op`` on ``N = n`` (for ``rank``, ``n``
    is the larger side of the matrix, and the reach is
    ``gauss_jordan.fits_big``'s)."""
    if op not in _WIDTH:
        return False
    if op == "inverse" and inv_rbt.fits(n):
        return True
    if op == "rank":
        return gauss_jordan.fits_big(n, n)
    return gauss_jordan.fits(n, _WIDTH[op](n))


def solve_fits(n: int, k: int = 1) -> bool:
    """Whether the pivoted kernel takes the solve of ``N = n`` with ``k``
    RHS columns (its ``[A | b]`` array is ``[n, n + k]``)."""
    return gauss_jordan.fits(n, n + k)


def _require(op: str, n: int) -> None:
    if not supports(op, n):
        raise ValueError(
            f"{op} at N={n}: past the kernels' reach (see "
            f"gauss_jordan.fits and inv_rbt.fits)")


def inverse_batched(a: torch.Tensor) -> torch.Tensor:
    """Small-N batched inverse: the fused RBT kernel where ``inv_rbt.fits``
    (in-kernel gate and rescue, no host read), else the pivoted kernel."""
    n = a.shape[-1]
    if inv_rbt.fits(n):
        return inv_rbt.inverse_rbt_fused_batched(a)
    _require("inverse", n)
    return gauss_jordan.inverse_batched(a)


def solve_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve by the pivoted kernel on ``[A | b]``, ``b`` ``[B, N]``
    or ``[B, N, k]``, where ``solve_fits``."""
    n = a.shape[-1]
    k = 1 if b.dim() == a.dim() - 1 else b.shape[-1]
    if not solve_fits(n, k):
        raise ValueError(
            f"solve at N={n} with k={k} RHS columns: [A | b] is past the "
            f"pivoted kernel's shared memory (see gauss_jordan.fits)")
    return gauss_jordan.solve_batched(a, b)


def det_batched(a: torch.Tensor) -> torch.Tensor:
    _require("det", a.shape[-1])
    return gauss_jordan.det_batched(a)


def rank_batched(
    a: torch.Tensor, tol: Optional[torch.Tensor] = None
) -> torch.Tensor:
    _require("rank", max(a.shape[-2:]))
    return gauss_jordan.rank_batched(a, tol=tol)
