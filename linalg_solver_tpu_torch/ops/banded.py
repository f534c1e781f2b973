"""Batched block-tridiagonal and banded solvers by block parallel cyclic
reduction (counterpart of ``linalg_solver_tpu.ops.banded``).

``ops.tridiag``'s PCR with ``[nb, nb]`` blocks for scalars: ⌈log₂ K⌉
data-parallel steps in which every product is a batched ``[nb, nb]``
product and every division a batched block solve (``torch.linalg.
solve``, the library's pivoted LU, as the reference's
``jnp.linalg.solve``).  A banded system with equal lower and upper
bandwidth kb is block-tridiagonal with blocks of nb ≥ kb, which gives
``banded_solve_batched`` on scipy's ``solve_banded`` storage.  No
pivoting across blocks (for the diagonally dominant and SPD bands of
splines and discretized operators); a singular reduced block leaves the
lane non-finite, reported as ``ok=False``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls


class BlockTridiagResult(NamedTuple):
    x: torch.Tensor   # [B, K, nb] (or [B, K, nb, k]); banded: [B, N(, k)]
    ok: torch.Tensor  # [B] the reduction stayed finite


def _solve_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve`` that does not raise: NaN where a block is
    exactly singular (the reference's ``jnp.linalg.solve`` comes back
    non-finite there)."""
    x, info = torch.linalg.solve_ex(a, b)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def _mask(K: int, keep, ndim: int, device) -> torch.Tensor:
    m = keep(torch.arange(K, device=device))
    return m.reshape((1, -1) + (1,) * (ndim - 2))


def _bshift_down(v: torch.Tensor, s: int, fill) -> torch.Tensor:
    K = v.shape[1]
    return torch.where(_mask(K, lambda k: k >= s, v.dim(), v.device),
                       torch.roll(v, s, dims=1), fill)


def _bshift_up(v: torch.Tensor, s: int, fill) -> torch.Tensor:
    K = v.shape[1]
    return torch.where(_mask(K, lambda k: k < K - s, v.dim(), v.device),
                       torch.roll(v, -s, dims=1), fill)


def _right_solve(d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``m d⁻¹`` through the transposes, as the reference solves it."""
    return _solve_nan(d.transpose(-1, -2), m.transpose(-1, -2)
                      ).transpose(-1, -2)


@f32_matmuls()
def block_tridiag_solve_batched(dl: torch.Tensor, d: torch.Tensor,
                                du: torch.Tensor, b: torch.Tensor
                                ) -> BlockTridiagResult:
    """Solve batched block-tridiagonal systems: ``dl/d/du [B, K, nb, nb]``
    the sub-, main- and super-diagonal blocks (``dl[:, 0]`` and
    ``du[:, -1]`` are ignored), ``b [B, K, nb]`` or ``[B, K, nb, k]``."""
    B, K, nb, _ = d.shape
    dtype = torch.promote_types(d.dtype, torch.float32)
    vector_input = b.dim() == 3
    b4 = (b[..., None] if vector_input else b).to(dtype)
    eye = torch.eye(nb, dtype=dtype, device=d.device).expand(d.shape)
    kidx = torch.arange(K, device=d.device).reshape(1, -1, 1, 1)
    zero = torch.zeros((), dtype=dtype, device=d.device)
    dl = torch.where(kidx != 0, dl.to(dtype), zero)
    du = torch.where(kidx != K - 1, du.to(dtype), zero)
    d = d.to(dtype)
    s = 1
    for _ in range(max(math.ceil(math.log2(max(K, 2))), 1)):
        alpha = -_right_solve(_bshift_down(d, s, eye), dl)
        beta = -_right_solve(_bshift_up(d, s, eye), du)
        d = d + alpha @ _bshift_down(du, s, zero) \
            + beta @ _bshift_up(dl, s, zero)
        b4 = b4 + alpha @ _bshift_down(b4, s, zero) \
            + beta @ _bshift_up(b4, s, zero)
        dl = alpha @ _bshift_down(dl, s, zero)
        du = beta @ _bshift_up(du, s, zero)
        s *= 2
    x = _solve_nan(d, b4)
    ok = torch.isfinite(x).reshape(B, -1).all(dim=1)
    return BlockTridiagResult(x[..., 0] if vector_input else x, ok)


def _band_to_blocks(ab: torch.Tensor, kb: int, K: int, nb: int):
    """scipy ``solve_banded`` storage ``ab [B, 2kb+1, N]``
    (``ab[:, kb + i − j, j] = A[i, j]``) → the block-tridiagonal diagonals
    ``(dl, d, du) [B, K, nb, nb]`` by one gather each."""
    N = K * nb
    # a zero row and nb zero columns for the out-of-band reads
    abp = torch.nn.functional.pad(ab, (0, nb, 0, 1))
    r = torch.arange(nb, device=ab.device)
    k = torch.arange(K, device=ab.device)

    def block(off: int):
        i = k[:, None, None] * nb + r[None, :, None]
        j = (k[:, None, None] + off) * nb + r[None, None, :]
        band_row = kb + i - j
        valid = (band_row >= 0) & (band_row <= 2 * kb) & (j >= 0) & (j < N)
        return abp[:, torch.where(valid, band_row, 2 * kb + 1),
                   torch.where(valid, j, N)]

    return block(-1), block(0), block(1)


def banded_solve_batched(ab: torch.Tensor, b: torch.Tensor,
                         kb: Optional[int] = None, nb: Optional[int] = None
                         ) -> BlockTridiagResult:
    """Solve batched banded systems ``A x = b`` with equal lower and upper
    bandwidth ``kb`` in scipy ``solve_banded`` storage, ``ab [B, 2kb+1,
    N]``; ``b [B, N]`` or ``[B, N, k]``.  The band is packed into
    ``nb``-sized block-tridiagonal form (any ``nb ≥ kb``; by default
    ``max(kb, min(32, N))``), N padded up to a multiple of nb with
    identity rows, then ``block_tridiag_solve_batched``."""
    B, rows, N = ab.shape
    if kb is None:
        kb = (rows - 1) // 2
    if rows != 2 * kb + 1:
        raise ValueError(f"ab must have 2·kb+1 = {2 * kb + 1} rows, "
                         f"got {rows}")
    if kb < 1:
        raise ValueError("use a diagonal scale for kb = 0")
    if nb is None:
        nb = max(kb, min(32, N))
    if nb < kb:
        raise ValueError(f"nb ({nb}) must be >= kb ({kb})")
    K = -(-N // nb)
    Np = K * nb
    if Np != N:
        # A ⊕ I, b ⊕ 0
        pad_ab = ab.new_zeros(B, 2 * kb + 1, Np - N)
        pad_ab[:, kb, :] = 1.0
        ab = torch.cat([ab, pad_ab], dim=2)
        b = torch.cat([b, b.new_zeros((B, Np - N) + tuple(b.shape[2:]))],
                      dim=1)
    dl, d, du = _band_to_blocks(ab, kb, K, nb)
    vector_input = b.dim() == 2
    bb = b.reshape((B, K, nb) if vector_input else (B, K, nb, b.shape[-1]))
    res = block_tridiag_solve_batched(dl, d, du, bb)
    x = res.x.reshape((B, Np) if vector_input else (B, Np, b.shape[-1]))
    return BlockTridiagResult(x[:, :N], res.ok)
