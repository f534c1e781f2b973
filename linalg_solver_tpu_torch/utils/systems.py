"""Systems that only a full RBT solve gets right, for ``chip_smoke.py``
and the tests.

Each function takes a well-conditioned ``w [N, N]`` (Gaussian plus
4√N·I, say) and returns an f32 system with about the same condition
number, on ``w``'s device, that a solver missing one part of the fused
kernel gets wrong:

- ``zero_minor_system``: the leading m×m minor is zero, so pivot-free LU
  without the butterfly meets a zero pivot and flags the system; with
  the butterfly nothing is flagged.
- ``pivot_system``: the system that the butterflies (U, V) map to a
  matrix whose first pivot is ``pivot``.  A small pivot (1e-3) makes the
  pivot-free factorization grow by ~max|w|/pivot, so the unrefined
  solution is off by ~1e-3 while two refinement rounds bring it to f32
  accuracy.  A zero pivot makes the draw (U, V) flag the system and
  leaves it to the rescue's redraw.
"""

from __future__ import annotations

import torch

from ..ops.rbt import butterfly_apply, shrink_depth


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


def pivot_system(
    w: torch.Tensor, diags_u: torch.Tensor, diags_v: torch.Tensor,
    pivot: float,
) -> torch.Tensor:
    """The ``A`` with ``Uᵀ A V = M``, where ``M`` is ``w`` with
    ``w[1, 0] = pivot`` and rows 0 and 1 swapped (so ``M[0, 0] =
    pivot`` and cond(M) ≈ cond(w)).  ``diags_u`` / ``diags_v`` are the
    ``[2, N]`` diagonals the solve will use; built in float64."""
    n = w.shape[-1]
    d = shrink_depth(n)
    eye = torch.eye(n, dtype=torch.float64, device=w.device)[None]
    ut = butterfly_apply(eye, diags_u[:d].double(), trans=True)[0]   # Uᵀ
    vt = butterfly_apply(eye, diags_v[:d].double(), trans=True)[0]   # Vᵀ
    m = w.double().clone()
    m[1, 0] = pivot
    m = m[[1, 0, *range(2, n)]]
    # Uᵀ A V = ut @ A @ vtᵀ = M  ⇔  A = ut⁻¹ M vt⁻ᵀ
    a = torch.linalg.solve(ut, torch.linalg.solve(vt, m.T).T)
    return a.to(torch.float32)
