"""Batched structured dense families: circulant, Hankel, Vandermonde
(counterpart of ``linalg_solver_tpu.ops.structured``).

- **Circulant** ``C(c)[i, j] = c[(i − j) mod n]``: diagonalized by the
  DFT, so the matvec and the exact solve are one FFT division; a lane is
  flagged where its symbol is numerically singular.
- **Hankel** ``H[i, j] = h[i + j]`` is ``T·J`` for the reversal ``J`` and
  a Toeplitz ``T``: matvec and solve through ``ops.toeplitz`` with one
  flip.
- **Vandermonde** ``V(x)[i, j] = x_i**j``: the Björck–Pereyra recurrences
  in O(n²), primal (Newton divided differences, then synthetic division)
  and dual (the transposed steps in reverse order).  Each of their two
  phases is a loop of n − 1 masked whole-vector steps (the reference's
  ``fori_loop``s, Python loops here).  The monomial basis is
  exponentially ill-conditioned: past n ≈ 16 the coefficients of a
  random interpolant leave f32's useful range, past n ≈ 30 the
  intermediates overflow (flagged).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .toeplitz import toeplitz_matvec_batched, toeplitz_solve_batched


# --- circulant ---------------------------------------------------------


class CirculantSolve(NamedTuple):
    """``x`` solves ``C(c) x = b`` where ``ok``; a lane whose smallest
    symbol is at or below ``rtol`` times its largest reports ``ok=False``
    and a mode-clamped pseudo-solve."""

    x: torch.Tensor   # [B, n]
    ok: torch.Tensor  # [B] bool


def circulant_dense_batched(c: torch.Tensor) -> torch.Tensor:
    """Materialize ``[B, n, n]`` with ``C[i, j] = c[(i − j) mod n]``."""
    n = c.shape[-1]
    idx = torch.arange(n, device=c.device)
    return c[..., (idx[:, None] - idx[None, :]) % n]


def circulant_matvec_batched(c: torch.Tensor, v: torch.Tensor
                             ) -> torch.Tensor:
    """``C(c) @ v`` in O(n log n): circular convolution by FFT."""
    out = torch.fft.ifft(torch.fft.fft(c) * torch.fft.fft(v), dim=-1)
    return out.real.to(v.dtype)


def circulant_solve_batched(c: torch.Tensor, b: torch.Tensor,
                            rtol: float = 1e-6) -> CirculantSolve:
    """Exact circulant solve ``x = ifft(fft(b) / fft(c))``; near-zero
    modes of a flagged lane are set to 1 (as ``strang_precond`` does)
    rather than amplified to Inf/NaN."""
    f_c = torch.fft.fft(c)
    f_b = torch.fft.fft(b)
    mag = f_c.abs()
    big = mag.amax(dim=-1, keepdim=True)
    ok = mag.amin(dim=-1) > rtol * big[..., 0]
    f_c_safe = torch.where(mag <= rtol * big, torch.ones_like(f_c), f_c)
    x = torch.fft.ifft(f_b / f_c_safe, dim=-1).real.to(b.dtype)
    return CirculantSolve(x=x, ok=ok)


# --- Hankel ------------------------------------------------------------


def _hankel_toeplitz_args(c: torch.Tensor, r: torch.Tensor):
    """The Toeplitz ``T`` with ``H(c, r) = T·J``: first column the last
    Hankel row ``r``, first row the reversed first Hankel column."""
    return r, c.flip(1)


def hankel_dense_batched(c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Materialize ``[B, n, n]`` with ``H[i, j] = h[i + j]`` from the first
    column ``c = h[0:n]`` and last row ``r = h[n−1:2n−1]`` (scipy's
    ``hankel`` convention, batched)."""
    n = c.shape[-1]
    h = torch.cat([c, r[:, 1:]], dim=-1)
    idx = torch.arange(n, device=c.device)
    return h[:, idx[:, None] + idx[None, :]]


def hankel_matvec_batched(c: torch.Tensor, r: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """``H(c, r) @ v = T (J v)`` in O(n log n)."""
    tc, tr = _hankel_toeplitz_args(c, r)
    return toeplitz_matvec_batched(tc, tr, v.flip(1))


def hankel_solve_batched(c: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                         tol=None, restart: int = 32, max_restarts: int = 16,
                         precond: bool = True):
    """Solve ``H(c, r) x = b``: ``T y = b`` by ``ops.toeplitz``'s
    Strang-preconditioned GMRES, then ``x = J y``.  Returns a
    ``KrylovResult``."""
    tc, tr = _hankel_toeplitz_args(c, r)
    res = toeplitz_solve_batched(tc, tr, b, tol=tol, restart=restart,
                                 max_restarts=max_restarts, precond=precond)
    return res._replace(x=res.x.flip(1))


# --- Vandermonde (Björck–Pereyra) --------------------------------------


class VandermondeSolve(NamedTuple):
    """``x`` solves the Vandermonde system where ``ok``; ``ok=False``
    marks numerically coincident nodes (a divided-difference denominator
    at or below ``rtol`` times the node spread) or an overflow."""

    x: torch.Tensor   # [B, n]
    ok: torch.Tensor  # [B] bool


def vandermonde_dense_batched(x: torch.Tensor) -> torch.Tensor:
    """Materialize ``[B, n, n]`` with ``V[i, j] = x_i**j``."""
    n = x.shape[-1]
    return x[..., :, None] ** torch.arange(n, device=x.device)[None, None, :]


def _bp_denominator(x: torch.Tensor, k: int, mask: torch.Tensor):
    """``x_i − x_{i−k}`` on masked rows, 1 elsewhere, and the masked
    minimum of its magnitude (for the coincident-node flag)."""
    den = x - torch.roll(x, k, dims=-1)
    den_safe = torch.where(mask, den, torch.ones_like(den))
    min_abs = torch.where(mask, den.abs(),
                          torch.full_like(den, float("inf"))).amin(dim=-1)
    return den_safe, min_abs


def _bp_ok(x: torch.Tensor, v: torch.Tensor, min_den: torch.Tensor,
           rtol: float) -> torch.Tensor:
    spread = x.amax(dim=-1) - x.amin(dim=-1)
    return (min_den > rtol * torch.clamp(spread, min=1e-30)) & \
        torch.isfinite(v).all(dim=-1)


@f32_matmuls()
def vandermonde_solve_batched(x: torch.Tensor, f: torch.Tensor,
                              rtol: float = 1e-6) -> VandermondeSolve:
    """Björck–Pereyra primal solve ``V(x) a = f`` in O(n²): the monomial
    coefficients of the interpolant through ``(x_i, f_i)``.  Phase 1,
    Newton divided differences; phase 2, Newton to monomial by
    synthetic division."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dtype)
    c = f.to(dtype)
    B, n = x.shape
    idx = torch.arange(n, device=x.device)
    min_den = torch.full((B,), float("inf"), dtype=dtype, device=x.device)
    # c[i] ← (c[i] − c[i−1]) / (x[i] − x[i−k]) for i ≥ k, k = 1 … n−1
    for k in range(1, n):
        mask = (idx >= k)[None, :]
        den, step_min = _bp_denominator(x, k, mask)
        c = torch.where(mask, (c - torch.roll(c, 1, dims=-1)) / den, c)
        min_den = torch.minimum(min_den, step_min)
    # c[j] ← c[j] − x_k c[j+1] for k ≤ j ≤ n−2, k = n−2 … 0
    for k in range(n - 2, -1, -1):
        mask = ((idx >= k) & (idx <= n - 2))[None, :]
        c = torch.where(mask, c - x[:, k:k + 1] * torch.roll(c, -1, dims=-1),
                        c)
    return VandermondeSolve(x=c.to(f.dtype), ok=_bp_ok(x, c, min_den, rtol))


@f32_matmuls()
def vandermonde_solve_t_batched(x: torch.Tensor, b: torch.Tensor,
                                rtol: float = 1e-6) -> VandermondeSolve:
    """Björck–Pereyra dual solve ``V(x)ᵀ w = b`` in O(n²) (the moment
    problem ``Σ_i w_i x_i**j = b_j``): the primal's elementary steps
    transposed, in reverse order."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dtype)
    w = b.to(dtype)
    B, n = x.shape
    idx = torch.arange(n, device=x.device)
    # w[i] ← w[i] − x_k w[i−1] for i ≥ k+1, k = 0 … n−2
    for k in range(n - 1):
        mask = (idx >= k + 1)[None, :]
        w = torch.where(mask, w - x[:, k:k + 1] * torch.roll(w, 1, dims=-1),
                        w)
    # u[i] = w[i] / (x_i − x_{i−k}) for i ≥ k; w[i] = u[i] − u[i+1] for
    # i ≥ k−1 (u[n] = 0), k = n−1 … 1
    min_den = torch.full((B,), float("inf"), dtype=dtype, device=x.device)
    last = (idx <= n - 2)[None, :]
    for k in range(n - 1, 0, -1):
        mask_div = (idx >= k)[None, :]
        den, step_min = _bp_denominator(x, k, mask_div)
        u = torch.where(mask_div, w / den, w)
        up1 = torch.where(last, torch.roll(u, -1, dims=-1),
                          torch.zeros_like(u))
        w = torch.where((idx >= k - 1)[None, :], u - up1, u)
        min_den = torch.minimum(min_den, step_min)
    return VandermondeSolve(x=w.to(b.dtype), ok=_bp_ok(x, w, min_den, rtol))
