"""Matrices that only a full RBT solve or inverse gets right, for
``chip_smoke.py`` and the tests.

Each function takes a well-conditioned ``w [N, N]`` (Gaussian plus
4√N·I, say) and returns an f32 matrix with about the same condition
number, on ``w``'s device, that a solver missing one part of the fused
kernels gets wrong:

- ``zero_minor_system``: the leading m×m minor is zero, so pivot-free LU
  without the butterfly meets a zero pivot and flags the system; with
  the butterfly nothing is flagged.
- ``pivot_system``: the system that the butterflies (U, V) map to a
  matrix whose first pivot is ``pivot``.  A small pivot (``SMALL_PIVOT``)
  makes the pivot-free factorization grow by ~max|w|/pivot, so the
  unrefined solution is off by ~1e-2 while two refinement rounds bring
  it to f32 accuracy.  A zero pivot makes the draw (U, V) flag the
  system and leaves it to the rescue's redraw.
- ``two_draw_zero_pivot_system``: a matrix whose first pivot is zero
  under two draws at once, so the inverse's redraw fails as well and
  only its pivoted level inverts it.

``inverse_probe_batch`` puts one matrix on every rung of the fused
inverse's rescue ladder.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.rbt import butterfly_apply, shrink_depth

#: matrices of ``inverse_probe_batch`` the fused inverse flags (zero,
#: NaN, and the two-draw matrix its pivoted level inverts)
INVERSE_FLAGGED = [1, 2, 6]

#: the first pivot of the refinement probe: the unrefined solution is
#: off by ≥ 2e-3 relative (24 systems, N = 64, 98, 256, k = 1, 8) and
#: the refined one by ≤ 7e-7
SMALL_PIVOT = 1e-4


def zero_minor_system(w: torch.Tensor, m: int = 16) -> torch.Tensor:
    """``w`` with ``w[N/2 : N/2+m, :m]`` zeroed and its two row halves
    swapped: the leading m×m minor is zero, the condition number is that
    of ``w`` less some of its off-diagonal noise."""
    n = w.shape[-1]
    h = n // 2
    if not 0 < m <= h:
        raise ValueError(f"m={m} must lie in 1..{h} for N={n}")
    out = w.to(torch.float32).clone()
    out[h:h + m, :m] = 0.0
    return torch.roll(out, h, dims=0)


def _butterfly_t(n: int, diags: torch.Tensor, device) -> torch.Tensor:
    """``Wᵀ`` of the depth-``shrink_depth(n)`` butterfly, ``[n, n]``
    float64."""
    d = shrink_depth(n)
    eye = torch.eye(n, dtype=torch.float64, device=device)[None]
    return butterfly_apply(eye, diags[:d].double(), trans=True)[0]


def pivot_system(
    w: torch.Tensor, diags_u: torch.Tensor, diags_v: torch.Tensor,
    pivot: float,
) -> torch.Tensor:
    """The ``A`` with ``Uᵀ A V = M``, where ``M`` is ``w`` with
    ``w[1, 0] = pivot`` and rows 0 and 1 swapped (so ``M[0, 0] =
    pivot`` and cond(M) ≈ cond(w)).  ``diags_u`` / ``diags_v`` are the
    ``[2, N]`` diagonals the solve will use; built in float64."""
    n = w.shape[-1]
    ut = _butterfly_t(n, diags_u, w.device)   # Uᵀ
    vt = _butterfly_t(n, diags_v, w.device)   # Vᵀ
    m = w.double().clone()
    m[1, 0] = pivot
    m = m[[1, 0, *range(2, n)]]
    # Uᵀ A V = ut @ A @ vtᵀ = M  ⇔  A = ut⁻¹ M vt⁻ᵀ
    a = torch.linalg.solve(ut, torch.linalg.solve(vt, m.T).T)
    return a.to(torch.float32)


def two_draw_zero_pivot_system(
    w: torch.Tensor,
    draw: Tuple[torch.Tensor, torch.Tensor],
    redraw: Tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """A regular matrix whose first pivot is zero under both butterfly
    draws: ``(Uᵀ A V)[0, 0] = (Rᵀ A S)[0, 0] = 0`` in exact arithmetic
    for ``draw = (U, V)`` and ``redraw = (R, S)`` (``[2, N]`` diagonals
    each).  Built in float64: ``w`` with its rows rolled by one, so that
    the 4√N·I part of ``w`` no longer meets the butterflies' first
    columns (``U e₀`` is nonzero on rows 0, N/4, N/2, 3N/4 only), plus
    the smallest combination ``α·(U e₀)(V e₀)ᵀ + β·(R e₀)(S e₀)ᵀ`` that
    zeroes both pivots.  That correction is of the order of one entry of
    the Gaussian part, so the condition number stays that of ``w``."""
    n = w.shape[-1]
    if n < 8:
        raise ValueError(f"N={n}: the butterflies' first columns need N >= 8")
    base = torch.roll(w.double(), 1, dims=0)
    cols = [_butterfly_t(n, d, w.device)[0] for d in (*draw, *redraw)]
    terms = [torch.outer(cols[0], cols[1]), torch.outer(cols[2], cols[3])]
    gram = torch.tensor(
        [[float((s * t).sum()) for t in terms] for s in terms],
        dtype=torch.float64)
    rhs = torch.tensor([-float((t * base).sum()) for t in terms],
                       dtype=torch.float64)
    coef = torch.linalg.solve(gram, rhs)
    a = base + coef[0] * terms[0] + coef[1] * terms[1]
    return a.to(torch.float32)


def inverse_probe_batch(
    a: torch.Tensor,
    draw: Tuple[torch.Tensor, torch.Tensor],
    redraw: Tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """A copy of the well-conditioned batch ``a [B >= 8, N, N]`` (N ≥ 8)
    with one matrix on every rung of the fused inverse's ladder, for the
    inverse's draw (U, V) and redraw (R, S):

    - 1 all zero and 2 with a NaN: flagged at every level;
    - 3 a zero leading N/4 minor: level 1, but only with the butterfly;
    - 4 first pivot 1e-6 under (U, V): only the probe rejects the
      level-1 inverse, the redraw inverts it;
    - 5 first pivot 0 under (U, V): the redraw inverts it;
    - 6 first pivot 0 under both draws: the pivoted level inverts it,
      and it stays flagged.

    The others are left as they are (level 1)."""
    n = a.shape[-1]
    out = a.to(torch.float32).clone()
    out[1] = 0.0
    out[2, 3, 5] = float("nan")
    out[3] = zero_minor_system(out[3], m=n // 4)
    out[4] = pivot_system(out[4], *draw, 1e-6)
    out[5] = pivot_system(out[5], *draw, 0.0)
    out[6] = two_draw_zero_pivot_system(out[6], draw, redraw)
    return out
