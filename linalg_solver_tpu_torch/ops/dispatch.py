"""Backend dispatch for the batched solve, inverse, determinant and rank
(counterpart of ``linalg_solver_tpu.ops.dispatch``).

Solve backends:

- ``"rbt"``  — random-butterfly pivot-free solve with the lane-compacted
  rescue (``ops.rbt.solve_rbt_batched``): the fused kernel where it
  reaches (even N, at most ``MAX_K_RHS`` RHS columns, its shared memory
  within a block's; ``kernels.solve_fused.fits``), else the phase engine.
- ``"xla"``  — the library's ``torch.linalg.solve``: the named baseline
  (the JAX package's ``"xla"`` is ``jnp.linalg.solve``).
- ``"auto"`` — ``"rbt"`` where the fused kernel reaches, and where the
  phase engine does (N a multiple of 8 below 1024, the reference's
  conditions), on every device alike.  Any other shape raises instead of
  quietly going to another solver.

Inverse, determinant and rank backends (the reference's names):

- ``"pallas"`` — the facade ``ops.kernels`` over the port's hand-written
  kernels (on the TPU, the Pallas kernels): the fused RBT inverse where
  it reaches, the pivoted Gauss–Jordan kernel for the rest.
- ``"xla"``    — the library's ``torch.linalg.inv`` / ``det`` /
  ``matrix_rank``.
- ``"auto"``   — ``"pallas"`` where the kernels reach; past that the
  inverse goes to the phase engine (``ops.rbt.inverse_rbt_batched``)
  where N is a multiple of 8 below 1024, as the reference routes it to
  ``"rbt"``.  Everything else raises until ROADMAP.md ports it (the
  blocked determinant and rank, N ≥ 1024).

The JAX package's TPU routing constants (``_XLA_CROSSOVER_N``,
``_RBT_SOLVE_MIN_N``, ``lanes_util_ok``) are TPU measurements and are
not carried over; a route is added here when the H100 measures it.  The
phase engine's bounds (N % 8 == 0, N < 1024) are the reference's reach,
not a measured crossover.
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


#: N past which the reference leaves the phase engine for the large-N
#: solvers (``_XLA_CROSSOVER_N``, used here as a reach, not a crossover)
PHASE_MAX_N = 1024


def phase_reaches(n: int) -> bool:
    """Whether the phase engine takes N = n where the reference routes it
    there: a panel width of 8 divides n (``_rbt_nb``) and n < 1024."""
    return n % 8 == 0 and 8 <= n < PHASE_MAX_N


def _resolve(backend: str, n: int, k: int) -> str:
    """The backend ``backend`` stands for at ``N = n`` with ``k`` RHS
    columns."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "auto":
        return backend
    if fits(n, k) or phase_reaches(n):
        return "rbt"
    raise NotImplementedError(
        f"backend='auto' has no route for N={n}, k={k} yet: past the fused "
        f"kernel (even N, k <= {MAX_K_RHS}, its shared memory) the phase "
        f"engine takes N % 8 == 0 below {PHASE_MAX_N}; the rest goes to the "
        f"blocked, mixed and large-N solvers that ROADMAP.md queue 1 item 7 "
        f"ports; pass backend='xla' meanwhile"
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
    if op == "inverse" and phase_reaches(n):
        return "rbt"
    raise NotImplementedError(
        f"backend='auto' has no route for {op} at N={n} yet: past the "
        f"kernels' shared memory the inverse takes the phase engine at "
        f"N % 8 == 0 below {PHASE_MAX_N}; the rest goes to the blocked "
        f"determinant, rank and the large-N solvers that ROADMAP.md queue 1 "
        f"item 7 ports; pass backend='xla' meanwhile"
    )


def _inverse_reaches(n: int, backend: str) -> bool:
    """Whether ``backend`` ("auto" or "pallas") inverts at N = n on the
    port's own route."""
    return _kernels.supports("inverse", n) or (
        backend == "auto" and phase_reaches(n))


def _inverse_impl(a: torch.Tensor, backend: str) -> torch.Tensor:
    be = _resolve_facade(backend, "inverse", a.shape[-1])
    if be == "pallas":
        return _kernels.inverse_batched(a)
    if be == "rbt":
        return _rbt.inverse_rbt_batched(a)
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
    if grad and not _inverse_reaches(n, backend):
        # the backward inverts A through the same route: refuse now, not
        # after the forward
        raise NotImplementedError(
            f"det at N={n} with a gradient: its backward needs the inverse, "
            f"which reaches N <= 167 and multiples of 8 below "
            f"{PHASE_MAX_N}; ROADMAP.md queue 1 item 7 ports the rest; pass "
            f"backend='xla' meanwhile"
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
    ``_Det``, on the kernels only where the inverse reaches."""
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
