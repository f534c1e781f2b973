"""Backend dispatch for the batched solve, inverse, determinant, rank and
LU factorization (counterpart of ``linalg_solver_tpu.ops.dispatch``).

Solve backends:

- ``"rbt"``  — random-butterfly pivot-free solve with the lane-compacted
  rescue (``ops.rbt.solve_rbt_batched``): the fused kernel where it
  reaches (even N, at most ``MAX_K_RHS`` RHS columns, its shared memory
  within a block's; ``kernels.solve_fused.fits``), else the phase engine.
- ``"mixed"`` — below N = 1024 the reduced-precision pivoted factor with
  f32 refinement and a pivoted rescue
  (``lu_blocked.pallas_solve_mixed_batched``, panel kernel 6, ``nb`` the
  first of 64, 48, 32, 16, 8 dividing N); from N = 1024 with N % 128 = 0
  and a vector RHS the RBT block elimination
  (``lu_large.large_solve_rbt``, kernel 4, ``nb`` 256 at N ≥ 2048 when
  it divides N, else 128).  Other shapes raise.
- ``"blocked_pallas"`` — the pivoted phase loop on panel kernel 6
  (``lu_blocked.pallas_solve_batched``, ``nb = min(64, N)`` dividing N).
- ``"pallas"`` — the pivoted Gauss–Jordan kernel on ``[A | b]``
  (``kernels.solve_batched``), vector or matrix RHS, where
  ``gauss_jordan.fits(N, N + k)`` (N ≤ 236 at k = 1).
- ``"xla"``  — the library's ``torch.linalg.solve``: the named baseline
  (the JAX package's ``"xla"`` is ``jnp.linalg.solve``).
- ``"auto"`` — ``"rbt"`` where the fused kernel reaches, and where the
  phase engine does (N a multiple of 8 below 1024, the reference's
  conditions); ``"mixed"`` from N = 1024 with N % 128 = 0 and a vector
  RHS, as the reference routes it; ``"xla"`` from N = 1024 with
  N % 128 ≠ 0, as the reference routes it; ``"pallas"`` where none of
  those takes the shape and kernel 3 does (odd N ≤ 235 at k = 1, and
  k > 8 at an N the phase engine refuses).  Any other shape raises
  instead of quietly going to another solver: it needs the reference's
  ``blocked`` and ``loop`` backends (ROADMAP.md queue 1 items 4–5).

Inverse, determinant and rank backends (the reference's names):

- ``"pallas"`` — the facade ``ops.kernels`` over the port's hand-written
  kernels (on the TPU, the Pallas kernels): the fused RBT inverse where
  it reaches (N % 4 = 0 to 180, the reference's reach), the pivoted
  Gauss–Jordan kernel for the rest (the inverse to N = 167, det and rank
  to 237).
- ``"blocked_pallas"`` — (inverse and det) the pivoted phase loop on
  panel kernel 6 (``lu_blocked.blocked_inverse_batched`` /
  ``pallas_det_batched``, ``nb = min(64, N)`` dividing N).
- ``"xla"``    — the library's ``torch.linalg.inv`` / ``det`` /
  ``matrix_rank``.
- ``"auto"``   — ``"pallas"`` where the kernels reach; past that the
  inverse goes to the phase engine (``ops.rbt.inverse_rbt_batched``)
  where N is a multiple of 8 below 1024, as the reference routes it to
  ``"rbt"``, and the determinant to ``"blocked_pallas"`` where
  ``min(64, N)`` divides N below 1024; from N = 1024 the inverse and
  the determinant go to ``"xla"``, as the reference routes them.
  Everything else raises until ROADMAP.md queue 1 items 4–5 port the
  reference's ``blocked``, ``loop`` and ``rref_blocked`` modules.

``lu_factor_batched`` has ``"blocked_pallas"`` (the packed L\\U of
``lu_blocked.blocked_lu_batched`` on panel kernel 6), and ``"auto"``
takes it wherever ``min(64, N)`` divides N, at every N, as the
reference does.

The routes follow the reference's reach, not crossovers measured on
the H100: the bounds used here (N % 8 == 0 and N < 1024 for the phase
engine, N ≥ 1024 with N % 128 == 0 for the large-N solve, ``min(64, N)``
dividing N for the blocked paths) are the reference's, and its TPU
crossover constants (``_RBT_SOLVE_MIN_N``, ``lanes_util_ok``) are not
carried over.  Some of these routes are slower than the library's call
on the H100; ``"auto"`` takes them all the same, and PERF.md keeps the
measured factors.  The large-N solve is the worst: 5–11× slower than
``torch.linalg.solve`` at N = 1024 and 2048 on an H100, host-bound on
its ~16,800 device operations a call.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels as _kernels
from . import lu_blocked as _lub
from . import lu_large as _lul
from . import rbt as _rbt
from .kernels.solve_fused import MAX_K_RHS, fits
from ..utils.precision import f32_matmuls

BACKENDS = ("auto", "rbt", "mixed", "blocked_pallas", "pallas", "xla")

#: backends of inverse_batched, det_batched and rank_batched
FACADE_BACKENDS = ("auto", "pallas", "blocked_pallas", "xla")

#: backends of lu_factor_batched
LU_BACKENDS = ("auto", "blocked_pallas")


#: N past which the reference leaves the phase engine for the large-N
#: solvers (``_XLA_CROSSOVER_N``, used here as a reach, not a crossover)
PHASE_MAX_N = 1024


def phase_reaches(n: int) -> bool:
    """Whether the phase engine takes N = n where the reference routes it
    there: a panel width of 8 divides n (``_rbt_nb``) and n < 1024."""
    return n % 8 == 0 and 8 <= n < PHASE_MAX_N


def large_reaches(n: int, vector_rhs: bool) -> bool:
    """Whether the large-N RBT solve takes N = n: n ≥ 1024, a multiple of
    128, and a vector RHS (the reference's ``"mixed"`` branch)."""
    return vector_rhs and n >= PHASE_MAX_N and n % 128 == 0


def _best_nb(n: int) -> int:
    """Panel width of the blocked paths (the reference's ``_best_nb``)."""
    return min(64, n)


def _blocked_ok(n: int) -> bool:
    """The blocked paths need N divisible by their panel width."""
    return n >= 8 and n % _best_nb(n) == 0


def _blocked_nb(n: int, what: str) -> int:
    if not _blocked_ok(n):
        raise ValueError(f"backend='blocked_pallas' ({what}) needs N >= 8 "
                         f"divisible by min(64, N); got N={n}")
    return _best_nb(n)


def _mixed_nb(n: int) -> int:
    """Panel width of the mixed solve below N = 1024 (the reference's
    ``_rbt_nb``): the first of 64, 48, 32, 16, 8 dividing N."""
    nb = next((w for w in (64, 48, 32, 16, 8) if n % w == 0), None)
    if nb is None:
        raise ValueError(f"backend='mixed' needs N divisible by a panel width "
                         f"in (64, 48, 32, 16, 8); got N={n}")
    return nb


def _resolve(backend: str, n: int, k: int, vector_rhs: bool) -> str:
    """The backend ``backend`` stands for at ``N = n`` with ``k`` RHS
    columns."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "auto":
        return backend
    if fits(n, k) or phase_reaches(n):
        return "rbt"
    if large_reaches(n, vector_rhs):
        return "mixed"
    if n >= PHASE_MAX_N and n % 128:
        return "xla"
    if _kernels.solve_fits(n, k):
        return "pallas"
    raise NotImplementedError(
        f"backend='auto' has no route for N={n}, k={k} yet: past the fused "
        f"kernel (even N, k <= {MAX_K_RHS}, its shared memory), the phase "
        f"engine (N % 8 == 0 below {PHASE_MAX_N}) and the pivoted kernel "
        f"(N <= 236 at k = 1) the reference takes the blocked and loop "
        f"solvers, which ROADMAP.md queue 1 items 4-5 port, and from "
        f"N = {PHASE_MAX_N} with N % 128 == 0 the large-N solve takes only "
        f"a vector RHS; pass backend='xla' meanwhile"
    )


def _solve_mixed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.shape[-1]
    if n < PHASE_MAX_N:
        return _lub.pallas_solve_mixed_batched(a, b, nb=_mixed_nb(n))
    if not large_reaches(n, b.dim() == a.dim() - 1):
        raise NotImplementedError(
            f"backend='mixed' at N={n} >= {PHASE_MAX_N} takes N % 128 == 0 "
            f"and a vector RHS: the large-N RBT solve, which takes only a "
            f"vector b in the reference too (ROADMAP.md queue 3); pass "
            f"backend='xla' for the rest")
    nb = 256 if n >= 2048 and n % 256 == 0 else 128
    return _lul.large_solve_rbt(a, b, nb=nb, ir_steps=2)


def _solve_impl(a: torch.Tensor, b: torch.Tensor, backend: str):
    vector_rhs = b.dim() == a.dim() - 1
    k = 1 if vector_rhs else b.shape[-1]
    n = a.shape[-1]
    be = _resolve(backend, n, k, vector_rhs)
    if be == "rbt":
        return _rbt.solve_rbt_batched(a, b)
    if be == "mixed":
        return _solve_mixed(a, b)
    if be == "blocked_pallas":
        return _lub.pallas_solve_batched(a, b, nb=_blocked_nb(n, "solve"))
    if be == "pallas":
        return _kernels.solve_batched(a, b)
    if vector_rhs:
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
    if backend == "blocked_pallas" and op == "rank":
        raise ValueError("rank_batched has no 'blocked_pallas' backend")
    if backend != "auto":
        return backend
    if _kernels.supports(op, n):
        return "pallas"
    if op == "inverse" and phase_reaches(n):
        return "rbt"
    if op == "det" and _blocked_ok(n) and n < PHASE_MAX_N:
        return "blocked_pallas"
    if op in ("inverse", "det") and n >= PHASE_MAX_N:
        return "xla"
    raise NotImplementedError(
        f"backend='auto' has no route for {op} at N={n} yet: past the "
        f"kernels' reach the inverse takes the phase engine at "
        f"N % 8 == 0 and the determinant the blocked phase loop at "
        f"N % min(64, N) == 0, both below {PHASE_MAX_N}; the reference "
        f"takes the rest below {PHASE_MAX_N}, and the rank past the "
        f"kernel, through its blocked, loop and rref_blocked modules, "
        f"which ROADMAP.md queue 1 items 4-5 port; pass backend='xla' "
        f"meanwhile"
    )


def _inverse_reaches(n: int, backend: str) -> bool:
    """Whether ``backend`` (not ``"xla"``) inverts at N = n on the port's
    own route."""
    if backend == "blocked_pallas":
        return _blocked_ok(n)
    return _kernels.supports("inverse", n) or (
        backend == "auto" and phase_reaches(n))


def _inverse_impl(a: torch.Tensor, backend: str) -> torch.Tensor:
    n = a.shape[-1]
    be = _resolve_facade(backend, "inverse", n)
    if be == "pallas":
        return _kernels.inverse_batched(a)
    if be == "rbt":
        return _rbt.inverse_rbt_batched(a)
    if be == "blocked_pallas":
        x = _lub.blocked_inverse_batched(
            a, nb=_blocked_nb(n, "inverse"), panel_backend="pallas")
        return x.to(a.dtype) if a.is_floating_point() else x
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
    be = _resolve_facade(backend, "det", n)
    if be == "xla":
        return torch.linalg.det(a)
    if grad and not _inverse_reaches(n, backend):
        # the backward inverts A through the same route: refuse now, not
        # after the forward
        raise NotImplementedError(
            f"det at N={n} with a gradient: its backward needs the inverse, "
            f"which reaches N <= 167, multiples of 4 to 180 and of 8 below "
            f"{PHASE_MAX_N}; the blocked and loop inverses of ROADMAP.md "
            f"queue 1 items 4-5 take the rest; pass backend='xla' meanwhile"
        )
    if be == "blocked_pallas":
        d = _lub.pallas_det_batched(a, nb=_blocked_nb(n, "det"))
        return d.to(a.dtype) if a.is_floating_point() else d
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


def lu_factor_batched(
    a: torch.Tensor, backend: str = "auto"
) -> _lub.BlockedLUResult:
    """Batched LU with partial pivoting, ``P A = L U``, of ``a [B, N, N]``
    in f32: ``lu_blocked.blocked_lu_batched`` on panel kernel 6 with
    ``nb = min(64, N)`` (two-level panels where the kernel's shared
    memory needs them).  Returns ``BlockedLUResult(lu, perm, sign, ok,
    l11_inv, u11_inv)``."""
    if backend not in LU_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {LU_BACKENDS}")
    n = a.shape[-1]
    if backend == "auto" and not _blocked_ok(n):
        raise NotImplementedError(
            f"backend='auto' has no route for lu_factor at N={n} yet: the "
            f"blocked phase loop takes N >= 8 divisible by min(64, N); the "
            f"loop backend for the rest is in ROADMAP.md queue 1 item 4")
    return _lub.blocked_lu_batched(a, nb=_blocked_nb(n, "lu_factor"))
