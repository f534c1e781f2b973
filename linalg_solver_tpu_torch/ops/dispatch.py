"""Backend dispatch for the batched solve, inverse, determinant and rank
(counterpart of ``linalg_solver_tpu.ops.dispatch``).

Solve backends:

- ``"rbt"``  — random-butterfly pivot-free solve through the fused
  kernel, with the lane-compacted rescue (``ops.rbt.solve_rbt_batched``).
- ``"xla"``  — the library's ``torch.linalg.solve``: the named baseline
  (the JAX package's ``"xla"`` is ``jnp.linalg.solve``).
- ``"auto"`` — ``"rbt"`` where the fused kernel reaches (even N, at most
  ``MAX_K_RHS`` RHS columns, and its shared memory within a block's;
  ``kernels.solve_fused.fits``), on every device alike.  No other route
  is ported yet, so any other shape raises instead of quietly going to
  another solver.

Inverse, determinant and rank backends (the reference's names):

- ``"pallas"`` — the facade ``ops.kernels`` over the port's hand-written
  kernels (on the TPU, the Pallas kernels): the fused RBT inverse where
  it reaches, the pivoted Gauss–Jordan kernel for the rest.
- ``"xla"``    — the library's ``torch.linalg.inv`` / ``det`` /
  ``matrix_rank``.
- ``"auto"``   — ``"pallas"`` where the kernels reach; past that it
  raises until ROADMAP.md queue 1 item 7 ports the rbt phase inverse
  and the blocked determinant.

The JAX package's TPU routing constants (``_XLA_CROSSOVER_N``,
``_RBT_SOLVE_MIN_N``, ``lanes_util_ok``) are TPU measurements and are
not carried over; a route is added here when the H100 measures it.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels as _kernels
from . import rbt as _rbt
from .kernels.solve_fused import MAX_K_RHS, fits
from ..utils.precision import f32_matmuls

BACKENDS = ("auto", "rbt", "xla")

#: backends of inverse_batched, det_batched and rank_batched
FACADE_BACKENDS = ("auto", "pallas", "xla")


def _resolve(backend: str, n: int, k: int) -> str:
    """The backend ``backend`` stands for at ``N = n`` with ``k`` RHS
    columns."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "auto":
        return backend
    if fits(n, k):
        return "rbt"
    raise NotImplementedError(
        f"backend='auto' has no route for N={n}, k={k} yet: odd N, "
        f"k > {MAX_K_RHS} and N past the fused kernel's shared memory go to "
        f"the phase engine, which ROADMAP.md queue 1 item 7 ports (the rbt "
        f"phase engine); pass backend='xla' meanwhile"
    )


def _solve_impl(a: torch.Tensor, b: torch.Tensor, backend: str):
    k = 1 if b.dim() == a.dim() - 1 else b.shape[-1]
    be = _resolve(backend, a.shape[-1], k)
    if be == "rbt":
        return _rbt.solve_rbt_batched(a, b)
    if b.dim() == a.dim() - 1:
        return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(a, b)


class _Solve(torch.autograd.Function):
    """Solve with a backward that reuses the solve: ``ȳ = A⁻ᵀ x̄`` (one
    solve of the transposed system through the same backend),
    ``Ā = −ȳ xᵀ``, ``b̄ = ȳ``."""

    @staticmethod
    def forward(ctx, a, b, backend):
        x = _solve_impl(a, b, backend)
        ctx.backend = backend
        ctx.save_for_backward(a, x)
        return x

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        gy = _solve_impl(a.transpose(-1, -2), g, ctx.backend)
        if x.dim() == a.dim():  # matrix RHS
            with f32_matmuls():
                abar = -(gy @ x.transpose(-1, -2))
        else:
            abar = -gy[..., :, None] * x[..., None, :]
        return abar.to(a.dtype), gy.to(x.dtype), None


def solve_batched(
    a: torch.Tensor, b: torch.Tensor, backend: str = "auto"
) -> torch.Tensor:
    """Batched linear solve ``a @ x = b`` for ``a [B, N, N]`` and ``b
    [B, N]`` or ``[B, N, k]``.  Differentiable through ``_Solve``."""
    return _Solve.apply(a, b, backend)


def _resolve_facade(backend: str, op: str, n: int) -> str:
    """The backend ``backend`` stands for for ``op`` at ``N = n``."""
    if backend not in FACADE_BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; one of {FACADE_BACKENDS}")
    if backend != "auto":
        return backend
    if _kernels.supports(op, n):
        return "pallas"
    raise NotImplementedError(
        f"backend='auto' has no route for {op} at N={n} yet: past the "
        f"kernels' shared memory it goes to the rbt phase inverse and the "
        f"blocked determinant, which ROADMAP.md queue 1 item 7 ports; pass "
        f"backend='xla' meanwhile"
    )


def _inverse_impl(a: torch.Tensor, backend: str) -> torch.Tensor:
    if _resolve_facade(backend, "inverse", a.shape[-1]) == "pallas":
        return _kernels.inverse_batched(a)
    return torch.linalg.inv(a)


class _Inverse(torch.autograd.Function):
    """Inverse with the backward ``Ā = −Xᵀ Ḡ Xᵀ`` (two products on the
    saved inverse, no second factorization)."""

    @staticmethod
    def forward(ctx, a, backend):
        x = _inverse_impl(a, backend)
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xt = x.transpose(-1, -2)
        with f32_matmuls():
            abar = -(xt @ g @ xt)
        return abar.to(x.dtype), None


def inverse_batched(a: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Batched inverse of ``a [B, N, N]``.  Differentiable through
    ``_Inverse``."""
    return _Inverse.apply(a, backend)


def _det_impl(a: torch.Tensor, backend: str, grad: bool) -> torch.Tensor:
    n = a.shape[-1]
    if _resolve_facade(backend, "det", n) != "pallas":
        return torch.linalg.det(a)
    if grad and not _kernels.supports("inverse", n):
        # the backward inverts A through the same kernels: refuse now,
        # not after the forward
        raise NotImplementedError(
            f"det at N={n} with a gradient: its backward needs the inverse, "
            f"which the kernels reach only to a smaller N; ROADMAP.md queue "
            f"1 item 7 ports the rbt phase inverse; pass backend='xla' "
            f"meanwhile"
        )
    return _kernels.det_batched(a)


class _Det(torch.autograd.Function):
    """Determinant with Jacobi's backward ``Ā = ḡ · det(A) · A⁻ᵀ``, the
    inverse through the same backend.  Like ``torch.linalg.det``'s, the
    gradient is defined only at nonsingular input."""

    @staticmethod
    def forward(ctx, a, backend):
        d = _det_impl(a, backend, ctx.needs_input_grad[0])
        ctx.backend = backend
        ctx.save_for_backward(a, d)
        return d

    @staticmethod
    def backward(ctx, g):
        a, d = ctx.saved_tensors
        inv_t = _inverse_impl(a, ctx.backend).transpose(-1, -2)
        return ((g * d)[..., None, None] * inv_t).to(a.dtype), None


def det_batched(a: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Batched determinant of ``a [B, N, N]``.  Differentiable through
    ``_Det``, on the kernels only where their inverse reaches."""
    return _Det.apply(a, backend)


def rank_batched(
    a: torch.Tensor, backend: str = "auto",
    tol: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched numerical rank of ``a [B, M, N]`` (int32).  ``tol`` is a
    per-matrix threshold ``[B]``; by default the kernel's
    ``max(M, N)·100·eps·max|A|`` (``"pallas"``) or the library's own
    (``"xla"``)."""
    if _resolve_facade(backend, "rank", max(a.shape[-2:])) == "pallas":
        return _kernels.rank_batched(a, tol=tol)
    if tol is None:
        return torch.linalg.matrix_rank(a).to(torch.int32)
    return torch.linalg.matrix_rank(a, atol=tol, rtol=0.0).to(torch.int32)
