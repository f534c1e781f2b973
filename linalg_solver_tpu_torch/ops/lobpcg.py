"""Batched LOBPCG: a few extreme eigenpairs of SPD matrices (counterpart
of ``linalg_solver_tpu.ops.lobpcg``).

The search basis ``S = [X | R | P] [B, n, 3k]`` has a fixed shape; each
step is batched products (``A S``, Gram matrices, basis rotations), a
CholeskyQR2 orthonormalization with a small ridge, and one ``eigh`` of
the projected ``[B, 3k, 3k]`` matrix.  Per-lane convergence masks freeze
finished lanes, and degenerate basis columns (converged residuals, the
first step's P) are replaced by fresh random directions, which keeps the
basis full rank with fixed shapes.

The reference's ``lax.while_loop`` runs in chunks of ``CHUNK`` here, under
the rule of ``ops.krylov.run_chunks``: each iteration gated as a whole on
the device, one host read a chunk, ``iters`` counted on the device.  The
random draws (the start block, the third block of the first basis, each
step's refresh directions) come from a CPU ``torch.Generator``, ``CHUNK``
steps' refreshes in one draw and one copy; tests inject the JAX
package's draws (``x0``, ``s0``, ``refresh``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls
from .krylov import run_chunks
from .spd import cholesky_or_nan

#: iterations between two host reads of the stop flag
CHUNK = 8

#: generator seed of the default draws (the reference's PRNGKey(0))
SEED = 0


class LOBPCGResult(NamedTuple):
    w: torch.Tensor          # [B, k] eigenvalues (ascending)
    V: torch.Tensor          # [B, n, k] orthonormal eigenvectors
    converged: torch.Tensor  # [B] all k residuals below tolerance
    iters: torch.Tensor      # [] int32: iterations executed
    resnorm: torch.Tensor    # [B, k] final ‖A v − λ v‖ / ‖A‖


def _gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2) @ y


def _chol_qr2(S: torch.Tensor, eps_scale: float) -> torch.Tensor:
    """CholeskyQR2 with a ridge of ``eps_scale`` times the mean squared
    column norm: orthonormal columns of ``S [B, n, m]``; a factor that
    fails leaves its lane NaN, as the reference's Cholesky does."""
    m = S.shape[-1]
    eye = torch.eye(m, dtype=S.dtype, device=S.device)
    for _ in range(2):
        G = _gram(S, S)
        ridge = eps_scale * torch.diagonal(G, dim1=1, dim2=2).sum(dim=1) / m
        L = cholesky_or_nan(G + ridge[:, None, None] * eye)
        # S ← S L⁻ᵀ
        S = torch.linalg.solve_triangular(
            L, S.transpose(1, 2), upper=False).transpose(1, 2)
    return S


def _eigh(t: torch.Tensor):
    """Ascending ``eigh`` of symmetric ``t [B, m, m]`` in float64, rounded
    back; a lane with a non-finite entry comes back NaN (the library
    raises there)."""
    fin = torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    w, V = torch.linalg.eigh(torch.where(fin[:, None, None], t, eye)
                             .to(torch.float64))
    nan = torch.full((), float("nan"), dtype=t.dtype, device=t.device)
    return (torch.where(fin[:, None], w.to(t.dtype), nan),
            torch.where(fin[:, None, None], V.to(t.dtype), nan))


class _Refresh:
    """``draw(it)``: the refresh directions of step ``it`` (``[B, n, m]``
    standard normal), drawn on ``generator`` ``block`` steps at a time
    and moved to ``device`` in one copy; steps are asked for in order."""

    def __init__(self, generator, shape, dtype, device, block):
        self.g, self.shape, self.dtype = generator, shape, dtype
        self.device, self.block, self.at, self.buf = device, block, -1, None

    def __call__(self, it: int) -> torch.Tensor:
        if it // self.block != self.at:
            self.at = it // self.block
            self.buf = torch.randn((self.block,) + self.shape,
                                   generator=self.g, dtype=self.dtype
                                   ).to(self.device)
        return self.buf[it % self.block]


@f32_matmuls()
def lobpcg_batched(
    a: torch.Tensor,
    k: int,
    largest: bool = False,
    tol: Optional[float] = None,
    max_iters: int = 200,
    generator: Optional[torch.Generator] = None,
    nguard: int = 2,
    x0: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
    refresh: Optional[Callable[[int], torch.Tensor]] = None,
) -> LOBPCGResult:
    """``k`` extreme eigenpairs of each symmetric positive definite
    matrix of ``a [B, n, n]`` (``3k ≤ n``): the k smallest
    (``largest=False``) or largest, ascending either way.

    ``nguard`` extra block vectors iterate alongside and are never
    reported or tested (insurance against converging on a non-extreme
    invariant subspace); it shrinks so that ``3(k + g) ≤ n``.  The draws
    come from ``generator`` (a CPU generator, by default seeded
    ``SEED``), or are given: ``x0`` and ``s0`` ``[B, n, k + g]`` (the start
    block and the third block of the first basis) and ``refresh(it)``
    ``[B, n, 3(k + g)]`` for step ``it`` (0 for the first basis)."""
    B, n, _ = a.shape
    if 3 * k > n:
        raise ValueError(f"lobpcg_batched needs 3k <= n, got k={k}, n={n}; "
                         f"use ops.symmetric.eigh_batched for full spectra")
    k_want = k
    k = min(k + max(nguard, 0), n // 3)
    dtype = torch.promote_types(a.dtype, torch.float32)
    a = a.to(dtype)
    dev = a.device
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    tol = float(torch.tensor(100.0 * eps if tol is None else tol,
                             dtype=dtype))
    m = 3 * k
    sign = -1.0 if largest else 1.0
    if x0 is None or s0 is None or refresh is None:
        g = generator or torch.Generator().manual_seed(SEED)
        x0 = torch.randn(B, n, k, generator=g, dtype=dtype).to(dev)
        s0 = torch.randn(B, n, k, generator=g, dtype=dtype).to(dev)
        refresh = _Refresh(g, (B, n, m), dtype, dev, CHUNK)
    anorm = torch.clamp(a.abs().sum(dim=2).amax(dim=1), min=tiny)

    def equilibrate(S, it):
        """Every column to unit norm; exactly-zero columns become fresh
        random directions."""
        colnorm = torch.sqrt((S * S).sum(dim=1))
        rnd = refresh(it).to(dtype)
        rnd = rnd / torch.sqrt((rnd * rnd).sum(dim=1))[:, None, :]
        dead = (colnorm <= tiny ** 0.5)[:, None, :]
        return torch.where(dead, rnd,
                           S / torch.clamp(colnorm, min=1e-30)[:, None, :])

    def rayleigh_ritz(S, it):
        Q = _chol_qr2(equilibrate(S, it), 10.0 * eps)
        T = _gram(Q, a @ Q)
        w_all, Y = _eigh(sign * 0.5 * (T + T.transpose(1, 2)))
        Yk = Y[:, :, :k]
        # the implicit P: the X-block rows of Y zeroed
        Yp = Yk.clone()
        Yp[:, :k, :] = 0.0
        return Q @ Yk, Q @ Yp, sign * w_all[:, :k]

    def residual(X, w):
        R = a @ X - X * w[:, None, :]
        return R, torch.sqrt((R * R).sum(dim=1)) / anorm[:, None]

    X, P, w = rayleigh_ritz(torch.cat([x0, a @ x0, s0], dim=2), 0)
    R, rn = residual(X, w)
    done0 = (rn[:, :k_want] <= tol).all(dim=1)
    step = 0

    def body(st):
        nonlocal step
        X, P, w, R, rn, done = st
        step += 1
        Xn, Pn, wn = rayleigh_ritz(torch.cat([X, R, P], dim=2), step)
        keep = done[:, None, None]
        X = torch.where(keep, X, Xn)
        P = torch.where(keep, P, Pn)
        w = torch.where(done[:, None], w, wn)
        R, rn = residual(X, w)
        return X, P, w, R, rn, done | (rn[:, :k_want] <= tol).all(dim=1)

    st, it = run_chunks(body, (X, P, w, R, rn, done0),
                        lambda st: ~st[5].all(), max_iters, chunk=CHUNK)
    X, _, w, _, rn, _ = st
    w, X, rn = w[:, :k_want], X[:, :, :k_want], rn[:, :k_want]
    if largest:
        w, X, rn = w.flip(1), X.flip(2), rn.flip(1)
    return LOBPCGResult(w, X, (rn <= 4.0 * tol).all(dim=1), it, rn)
