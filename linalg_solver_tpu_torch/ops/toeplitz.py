"""Batched Toeplitz operators: FFT matvec and circulant-preconditioned
Krylov solves (counterpart of ``linalg_solver_tpu.ops.toeplitz``).

A Toeplitz matrix is its first column ``c [B, n]`` and first row
``r [B, n]`` (``r[:, 0] = c[:, 0]``).  The matvec runs in O(n log n)
through the 2n circulant embedding (one FFT of the embedding column,
reused across products); solves compose it with the matrix-free Krylov
cores (``ops.krylov``) under Strang's circulant preconditioner, one FFT
division.  The FFTs are ``torch.fft`` (cuFFT on the card), complex64
from float32 inputs; results return as float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.precision import f32_matmuls
from .krylov import KrylovResult, cg_matvec, gmres_matvec


def _embed_col(c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """First column of the 2n circulant embedding:
    ``[c_0 … c_{n−1}, 0, r_{n−1} … r_1]``."""
    return torch.cat([c, c.new_zeros(c.shape[0], 1), r[:, 1:].flip(1)],
                     dim=1)


def _conv(f_emb: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    f_v = torch.fft.fft(v, n=2 * n, dim=1)
    return torch.fft.ifft(f_emb * f_v, dim=1)[:, :n].real.to(v.dtype)


def toeplitz_matvec_batched(c: torch.Tensor, r: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """``T(c, r) @ v`` in O(n log n) a lane through the circulant
    embedding."""
    return _conv(torch.fft.fft(_embed_col(c, r)), v, c.shape[1])


def make_toeplitz_matvec(c: torch.Tensor, r: torch.Tensor):
    """Closure form with the embedding's FFT computed once, for the
    ``ops.krylov`` matrix-free solvers."""
    n = c.shape[1]
    f_emb = torch.fft.fft(_embed_col(c, r))
    return lambda v: _conv(f_emb, v, n)


def strang_precond(c: torch.Tensor, r: torch.Tensor):
    """Strang's circulant preconditioner: the central diagonals
    (``|k| ≤ n/2``) copied into a circulant, inverted in Fourier space.
    Fourier symbols at or below 1e-6 of the largest are set to 1 (those
    modes pass through unpreconditioned)."""
    n = c.shape[1]
    k = torch.arange(n, device=c.device)
    r_wrap = r[:, torch.where(k == 0, 0, n - k)]
    s = torch.where((k <= n // 2)[None, :], c, r_wrap)
    f_s = torch.fft.fft(s)
    mag = f_s.abs()
    floor = 1e-6 * mag.amax(dim=1, keepdim=True)
    f_s = torch.where(mag <= floor, torch.ones_like(f_s), f_s)

    def precond(v):
        return torch.fft.ifft(torch.fft.fft(v, dim=1) / f_s,
                              dim=1).real.to(v.dtype)

    return precond


def toeplitz_dense_batched(c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Materialize ``[B, n, n]`` (tests and small fallbacks)."""
    n = c.shape[1]
    idx = torch.arange(n, device=c.device)
    d = idx[:, None] - idx[None, :]
    from_c = c[:, d.clamp(0, n - 1)]
    from_r = r[:, (-d).clamp(0, n - 1)]
    return torch.where((d >= 0)[None], from_c, from_r)


@f32_matmuls()
def toeplitz_solve_batched(
    c: torch.Tensor,
    r: torch.Tensor,
    b: torch.Tensor,
    spd: bool = False,
    tol: Optional[float] = None,
    restart: int = 32,
    max_restarts: int = 16,
    precond: bool = True,
) -> KrylovResult:
    """Solve batched Toeplitz systems ``T(c, r) x = b`` in O(n log n ·
    iters): Strang-preconditioned GMRES, or CG with ``spd=True`` for a
    symmetric positive definite T (``r = c``).  Per-lane ``converged``
    and true relative residuals, as ``ops.krylov``."""
    dtype = torch.promote_types(c.dtype, torch.float32)
    c, r = c.to(dtype), r.to(dtype)
    matvec = make_toeplitz_matvec(c, r)
    M = strang_precond(c, r) if precond else None
    if spd:
        return cg_matvec(matvec, b, tol=tol, precond=M)
    return gmres_matvec(matvec, b, tol=tol, restart=restart,
                        max_restarts=max_restarts, precond=M)
