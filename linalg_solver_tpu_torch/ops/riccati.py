"""Batched algebraic Riccati equations (counterpart of
``linalg_solver_tpu.ops.riccati``).

``care_batched``: ``AᵀX + XA − X B R⁻¹ Bᵀ X + Q = 0`` by the matrix-sign
method (Roberts).  The stabilizing solution spans the stable invariant
subspace of the Hamiltonian

    H = [[A, −G], [−Q, −Aᵀ]],   G = B R⁻¹ Bᵀ,

and with ``S = sign(H)`` (``ops.sign``) the subspace condition
``(I − S)/2 · [I; X] = [I; X]`` becomes one overdetermined linear system

    [[S₁₂], [S₂₂ + I]] · X = −[[S₁₁ + I], [S₂₁]],

solved least-squares (``ops.lstsq``).  The true relative residual gates
``ok``: a Hamiltonian with eigenvalues on the imaginary axis (no
stabilizing solution) breaks the sign iteration and is flagged.

``dare_batched``: the discrete equation by the structure-preserving
doubling algorithm.  The reference's ``while_loop`` stops when every lane
is done; here the host reads that flag once a step, so ``iters`` is the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .lstsq import lstsq_batched
from .schur import _f32
from .sign import sign_batched
from .spd import cholesky_solve_batched
from .sylvester import solve_or_nan


class CAREResult(NamedTuple):
    X: torch.Tensor      # [B, n, n] symmetric stabilizing solution
    resid: torch.Tensor  # [B] relative CARE residual
    ok: torch.Tensor     # [B]


def _sym(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x + x.transpose(1, 2))


def _nrm(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax((1, 2))


def _gain(r, b):
    """``(G, ok_r)``: ``G = B R⁻¹ Bᵀ`` (symmetrized) by an SPD solve."""
    rinv_bt, ok_r = cholesky_solve_batched(r, b.transpose(1, 2))
    return _sym(b @ rinv_bt), ok_r


@f32_matmuls()
def care_batched(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                 r: torch.Tensor, rtol: float = 1e-3) -> CAREResult:
    """Solve batched CAREs (``a [B,n,n]``, ``b [B,n,m]``, symmetric
    ``q [B,n,n]``, SPD ``r [B,m,m]``)."""
    a, b, r = _f32(a), _f32(b), _f32(r)
    q = _f32(_sym(q))
    n = a.shape[1]
    G, ok_r = _gain(r, b)
    H = torch.cat([torch.cat([a, -G], 2),
                   torch.cat([-q, -a.transpose(1, 2)], 2)], 1)
    sg = sign_batched(H)
    S11, S12 = sg.S[:, :n, :n], sg.S[:, :n, n:]
    S21, S22 = sg.S[:, n:, :n], sg.S[:, n:, n:]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    lhs = torch.cat([S12, S22 + eye], 1)                  # [B, 2n, n]
    rhs = -torch.cat([S11 + eye, S21], 1)                 # [B, 2n, n]
    ls = lstsq_batched(lhs, rhs)
    X = _sym(ls.x)

    # the true CARE residual, relative to the equation's term scale
    at_x = a.transpose(1, 2) @ X
    xgx = X @ (G @ X)
    R = at_x + at_x.transpose(1, 2) - xgx + q
    scale = (_nrm(at_x) + _nrm(xgx) + _nrm(q)).clamp(min=1e-30)
    resid = _nrm(R) / scale
    ok = ok_r & sg.converged & ls.ok & (resid < rtol)
    return CAREResult(X, resid, ok)


class DAREResult(NamedTuple):
    X: torch.Tensor      # [B, n, n] symmetric stabilizing solution
    resid: torch.Tensor  # [B] relative DARE residual
    ok: torch.Tensor     # [B]
    iters: torch.Tensor  # [] i32


@f32_matmuls()
def dare_batched(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
                 r: torch.Tensor, rtol: float = 1e-3,
                 max_iters: int = 30) -> DAREResult:
    """Discrete algebraic Riccati equation
    ``AᵀXA − X − AᵀXB(R + BᵀXB)⁻¹BᵀXA + Q = 0`` by the
    structure-preserving doubling algorithm (SDA):

        E ← E(I + GH)⁻¹E,  G ← G + E(I + GH)⁻¹G Eᵀ,
        H ← H + Eᵀ H(I + GH)⁻¹ E,

    from ``E₀ = A, G₀ = BR⁻¹Bᵀ, H₀ = Q``; ``H`` converges quadratically
    to the stabilizing X (each sweep is batched products and one batched
    solve).  The true DARE residual gates ``ok``."""
    a, b, r = _f32(a), _f32(b), _f32(r)
    q = _f32(_sym(q))
    B, n, _ = a.shape
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    eps = torch.finfo(a.dtype).eps
    G, ok_r = _gain(r, b)
    E, H = a, q
    done = torch.zeros(B, dtype=torch.bool, device=a.device)
    k = 0
    while k < max_iters and not bool(done.all()):
        W = eye + G @ H
        Winv_E = solve_or_nan(W, E)
        Winv_G = solve_or_nan(W, G)
        E_new = E @ Winv_E
        G_new = _sym(G + E @ (Winv_G @ E.transpose(1, 2)))
        H_new = _sym(H + E.transpose(1, 2) @ (H @ Winv_E))
        step = _nrm(H_new - H) / _nrm(H_new).clamp(min=1e-30)
        done_new = (done | (step < 4.0 * eps)
                    | ~torch.isfinite(H_new).all(dim=(1, 2)))
        m = (~done)[:, None, None]
        E = torch.where(m, E_new, E)
        G = torch.where(m, G_new, G)
        H = torch.where(m, H_new, H)
        done = done_new
        k += 1
    X = _sym(H)

    # the true DARE residual: AᵀXA − X − AᵀXB(R + BᵀXB)⁻¹BᵀXA + Q
    xa = X @ a
    at_xa = a.transpose(1, 2) @ xa                        # AᵀXA
    bt_xa = b.transpose(1, 2) @ xa                        # BᵀXA [B, m, n]
    r_in = r + b.transpose(1, 2) @ (X @ b)
    sol, ok_in = cholesky_solve_batched(r_in, bt_xa)
    corr = bt_xa.transpose(1, 2) @ sol
    R_ = at_xa - X - corr + q
    scale = (_nrm(at_xa) + _nrm(X) + _nrm(corr) + _nrm(q)).clamp(min=1e-30)
    resid = _nrm(R_) / scale
    ok = (ok_r & ok_in & done & (resid < rtol)
          & torch.isfinite(X).all(dim=(1, 2)))
    return DAREResult(X, resid, ok, torch.tensor(k, dtype=torch.int32,
                                                 device=a.device))
