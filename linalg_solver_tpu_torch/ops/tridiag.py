"""Batched tridiagonal solver: parallel cyclic reduction (PCR)
(counterpart of ``linalg_solver_tpu.ops.tridiag``).

The Thomas algorithm is a length-n sequential recurrence.  PCR instead
eliminates the sub- and super-diagonals in ⌈log₂ n⌉ data-parallel steps:
at stride s every row absorbs its ±s neighbours, doubling the stride,
until the system is diagonal.  Each step is a handful of elementwise ops
over the whole ``[B, n]`` batch: O(n log n) work at log depth, as plain
torch on the tensors' device.

No pivoting (like every cyclic-reduction solver): meant for the
diagonally dominant / SPD tridiagonals of splines, ADI sweeps and
discretized 1-D operators.  A zero pivot met mid-reduction gives inf/nan
in that lane, reported as ``ok=False``, never a silently wrong answer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class TridiagResult(NamedTuple):
    x: torch.Tensor   # [B, n] or [B, n, k]
    ok: torch.Tensor  # [B] the reduction stayed finite


def _shift_down(v: torch.Tensor, s: int, fill: float = 0.0) -> torch.Tensor:
    """v[i-s] along axis 1, ``fill`` where i < s."""
    out = torch.full_like(v, fill)
    if s < v.shape[1]:
        out[:, s:] = v[:, :-s]
    return out


def _shift_up(v: torch.Tensor, s: int, fill: float = 0.0) -> torch.Tensor:
    """v[i+s] along axis 1, ``fill`` where i ≥ n - s."""
    out = torch.full_like(v, fill)
    if s < v.shape[1]:
        out[:, :-s] = v[:, s:]
    return out


def tridiag_solve_batched(dl: torch.Tensor, d: torch.Tensor,
                          du: torch.Tensor, b: torch.Tensor
                          ) -> TridiagResult:
    """Solve batched tridiagonal systems.

    ``dl/d/du [B, n]``: sub-, main- and super-diagonal (``dl[:, 0]`` and
    ``du[:, -1]`` are ignored); ``b [B, n]`` or ``[B, n, k]``."""
    B, n = d.shape
    dtype = torch.promote_types(d.dtype, torch.float32)
    vector_input = b.dim() == 2
    b3 = (b[:, :, None] if vector_input else b).to(dtype)
    dl = dl.to(dtype).clone()
    du = du.to(dtype).clone()
    dl[:, 0] = 0.0
    du[:, n - 1] = 0.0
    d = d.to(dtype)

    s = 1
    for _ in range(max(math.ceil(math.log2(max(n, 2))), 1)):
        alpha = -dl / _shift_down(d, s, fill=1.0)
        beta = -du / _shift_up(d, s, fill=1.0)
        d = d + alpha * _shift_down(du, s) + beta * _shift_up(dl, s)
        b3 = (b3 + alpha[:, :, None] * _shift_down(b3, s)
              + beta[:, :, None] * _shift_up(b3, s))
        dl = alpha * _shift_down(dl, s)
        du = beta * _shift_up(du, s)
        s *= 2

    x = b3 / d[:, :, None]
    ok = torch.isfinite(x).all(dim=2).all(dim=1)
    return TridiagResult(x[:, :, 0] if vector_input else x, ok)
