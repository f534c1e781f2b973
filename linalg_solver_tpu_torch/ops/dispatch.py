"""Backend dispatch for the batched solve, inverse, determinant, rank,
LU factorization, affine solve and nullspace (counterpart of
``linalg_solver_tpu.ops.dispatch``).

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
- ``"blocked"`` — the reference's XLA-panel blocked LU with one
  refinement round (``lu_blocked.blocked_solve_batched``: the library's
  pivoted LU), ``min(64, N)`` dividing N.
- ``"pallas"`` — the pivoted Gauss–Jordan kernel on ``[A | b]``
  (``kernels.solve_batched``), vector or matrix RHS, where
  ``gauss_jordan.fits(N, N + k)`` (N ≤ 236 at k = 1).
- ``"loop"`` — the LU loop with partial pivoting (``ops.lu``), every
  shape: the correctness oracle.
- ``"xla"``  — the library's ``torch.linalg.solve``: the named baseline
  (the JAX package's ``"xla"`` is ``jnp.linalg.solve``).
- ``"dd"`` — f64-class backward error: ``dd.solve_dd_batched`` (one f32
  LU on panel kernel 6 or the LU loop, refinement with float64
  residuals), vector RHS; returns ``x_hi + x_lo`` collapsed to f32, as
  the reference does.
- ``"auto"`` — ``"rbt"`` where the fused kernel reaches, and where the
  phase engine does (N a multiple of 8 below 1024).  This departs from
  the reference at even N < 256: the reference takes Gauss–Jordan there
  (N ≤ 127), then ``"mixed"`` below 256, and only then RBT; the port
  runs the fused RBT kernel from the smallest even N.  No H100
  measurement chose either route (ROADMAP.md queue 3, "a route that
  differs, unmeasured"; the port's benchmark settles it).  ``"mixed"``
  from N = 1024 with N % 128 = 0 and a vector
  RHS, as the reference routes it; ``"xla"`` from N = 1024 with
  N % 128 ≠ 0, as the reference routes it; ``"pallas"`` where none of
  those takes the shape and kernel 3 does (odd N ≤ 235 at k = 1, and
  k > 8 at an N the phase engine refuses); ``"loop"`` for the rest
  below 1024, as the reference ends.  A matrix RHS from N = 1024 with
  N % 128 = 0 raises: the reference's large-N solve refuses it too.

Inverse, determinant and rank backends (the reference's names):

- ``"pallas"`` — the facade ``ops.kernels`` over the port's hand-written
  kernels (on the TPU, the Pallas kernels): the fused RBT inverse where
  it reaches (N % 4 = 0 to 180, the reference's reach), the pivoted
  Gauss–Jordan kernel for the rest (the inverse to N = 167, det to 237,
  the rank to 424).
- ``"blocked_pallas"`` — (inverse and det) the pivoted phase loop on
  panel kernel 6 (``lu_blocked.blocked_inverse_batched`` /
  ``pallas_det_batched``, ``nb = min(64, N)`` dividing N).
- ``"blocked"`` — the det on the library-backed blocked LU
  (``lu_blocked.blocked_det_batched``); the rank on the blocked RREF
  (``rref_blocked.rank_blocked_batched``) from max(M, N) = 256, else the
  loop; the inverse, as in the reference, the loop's.
- ``"loop"`` — Gauss–Jordan on ``[A | I]`` with ``tol = 1e-30`` (the
  inverse, ``ops.solve``), the LU loop (det), Gauss–Jordan pivot
  counting (rank).
- ``"xla"``    — the library's ``torch.linalg.inv`` / ``det`` /
  ``matrix_rank``.
- ``"dd"`` — (inverse) ``dd.inverse_dd_batched`` (the ``"auto"``
  inverse, then Newton–Schulz rounds with float64 residuals), collapsed
  to f32.
- ``"auto"``   — ``"pallas"`` where the kernels reach; past that the
  inverse goes to the phase engine (``ops.rbt.inverse_rbt_batched``)
  where N is a multiple of 8 below 1024, as the reference routes it to
  ``"rbt"``, and the determinant to ``"blocked_pallas"`` where
  ``min(64, N)`` divides N below 1024; from N = 1024 the inverse and
  the determinant go to ``"xla"``, as the reference routes them; the
  rest below 1024 to ``"loop"``.  The rank: kernel 3 to max(M, N) =
  424, the blocked RREF past that.

``lu_factor_batched`` has ``"blocked_pallas"`` (the packed L\\U of
``lu_blocked.blocked_lu_batched`` on panel kernel 6), ``"blocked"`` (the
same result type from the library's LU) and ``"loop"`` (``ops.lu``'s
``LUResult``); ``"auto"`` takes ``"blocked_pallas"`` wherever
``min(64, N)`` divides N, at every N, and the loop elsewhere, as the
reference does.

``affine_solve_batched`` and ``nullspace_batched`` return padded affine
solution sets (``ops.solve.BatchedAffineSubspace``): kernel 3 where the
square-padded ``[s, s + 1]`` is in its big reach (s ≤ 423; backends
``"auto"`` and ``"pallas"``), the blocked RREF from max(M, N) = 256
(``"auto"`` and ``"blocked"``), else the loop with partial pivoting.

The routes follow the reference's reach, not crossovers measured on
the H100: the bounds used here (N % 8 == 0 and N < 1024 for the phase
engine, N ≥ 1024 with N % 128 == 0 for the large-N solve, ``min(64, N)``
dividing N for the blocked paths, the big VMEM budget for the rank and
the affine solve) are the reference's, and its TPU crossover constants
(``_RBT_SOLVE_MIN_N``, ``lanes_util_ok``) are not carried over.  Some
of these routes are slower than the library's call on the H100;
``"auto"`` takes them all the same, and PERF.md keeps the measured
factors.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch

from . import dd as _dd
from . import kernels as _kernels
from . import lu as _lu
from . import lu_blocked as _lub
from . import lu_large as _lul
from . import rbt as _rbt
# the package binds the functions ``rref_blocked`` and ``solve`` over
# these modules' names (as the reference does)
_rrb = importlib.import_module(".rref_blocked", __package__)
_solve = importlib.import_module(".solve", __package__)
from .kernels.gauss_jordan import _like
from .kernels.solve_fused import fits
from ..utils.precision import f32_matmuls

BACKENDS = ("auto", "rbt", "mixed", "blocked_pallas", "blocked", "pallas",
            "loop", "xla", "dd")

#: backends of inverse_batched and det_batched ("dd": the inverse only)
FACADE_BACKENDS = ("auto", "pallas", "blocked_pallas", "blocked", "loop",
                   "xla", "dd")

#: backends of rank_batched
RANK_BACKENDS = ("auto", "pallas", "blocked", "loop", "xla")

#: backends of lu_factor_batched ("pallas" raises: the facade has no LU)
LU_BACKENDS = ("auto", "blocked_pallas", "blocked", "loop", "pallas")

#: backends of affine_solve_batched and nullspace_batched
AFFINE_BACKENDS = ("auto", "pallas", "blocked", "loop")

#: N past which the reference leaves the phase engine for the large-N
#: solvers (``_XLA_CROSSOVER_N``, used here as a reach, not a crossover)
PHASE_MAX_N = 1024

#: max(M, N) from which the reference's rank and affine solve take the
#: blocked RREF when the kernel does not reach (``dispatch.py:362,392``)
BLOCKED_RREF_MIN_N = 256

#: the Gauss–Jordan inverse's pivot threshold on the loop route
#: (``dispatch.py:338``)
LOOP_INVERSE_TOL = 1e-30


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


def _blocked_nb(n: int, what: str, backend: str = "blocked_pallas") -> int:
    if not _blocked_ok(n):
        raise ValueError(f"backend={backend!r} ({what}) needs N >= 8 "
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


def _large_matrix_rhs(n: int) -> NotImplementedError:
    return NotImplementedError(
        f"N={n} >= {PHASE_MAX_N} with N % 128 == 0 takes the large-N RBT "
        f"solve, which takes only a vector RHS, in the reference too "
        f"(ROADMAP.md queue 3); pass backend='xla' or 'loop' for a matrix "
        f"RHS")


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
    if n >= PHASE_MAX_N:
        raise _large_matrix_rhs(n)
    if _kernels.solve_fits(n, k):
        return "pallas"
    return "loop"


def _solve_mixed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.shape[-1]
    if n < PHASE_MAX_N:
        return _lub.pallas_solve_mixed_batched(a, b, nb=_mixed_nb(n))
    if not large_reaches(n, b.dim() == a.dim() - 1):
        raise _large_matrix_rhs(n)
    nb = 256 if n >= 2048 and n % 256 == 0 else 128
    return _lul.large_solve_rbt(a, b, nb=nb, ir_steps=2)


def _solve_impl(a: torch.Tensor, b: torch.Tensor, backend: str):
    vector_rhs = b.dim() == a.dim() - 1
    k = 1 if vector_rhs else b.shape[-1]
    n = a.shape[-1]
    be = _resolve(backend, n, k, vector_rhs)
    if be == "dd":
        if not vector_rhs:
            raise ValueError("backend='dd' solves a vector RHS [B, N]")
        r = _dd.solve_dd_batched(a, b)
        return r.x_hi + r.x_lo
    if be == "rbt":
        return _rbt.solve_rbt_batched(a, b)
    if be == "mixed":
        return _solve_mixed(a, b)
    if be == "blocked_pallas":
        return _lub.pallas_solve_batched(a, b, nb=_blocked_nb(n, "solve"))
    if be == "blocked":
        return _lub.blocked_solve_batched(
            a, b, nb=_blocked_nb(n, "solve", be))
    if be == "pallas":
        return _kernels.solve_batched(a, b)
    if be == "loop":
        return _lu.solve_lu_batched(a, b)
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
    """The backend ``backend`` stands for for ``op`` (``"inverse"`` or
    ``"det"``) at ``N = n``."""
    if backend not in FACADE_BACKENDS or (backend == "dd" and op == "det"):
        raise ValueError(
            f"unknown backend {backend!r} for {op}; one of {FACADE_BACKENDS}"
            f" ('dd': the inverse only)")
    if backend != "auto":
        return backend
    if _kernels.supports(op, n):
        return "pallas"
    if op == "inverse" and phase_reaches(n):
        return "rbt"
    if op == "det" and _blocked_ok(n) and n < PHASE_MAX_N:
        return "blocked_pallas"
    if n >= PHASE_MAX_N:
        return "xla"
    return "loop"


def _inverse_reaches(n: int, backend: str) -> bool:
    """Whether ``backend`` inverts at N = n (the det's backward takes the
    inverse through the same backend)."""
    if backend == "blocked_pallas":
        return _blocked_ok(n)
    if backend == "pallas":
        return _kernels.supports("inverse", n)
    return True


def _inverse_impl(a: torch.Tensor, backend: str) -> torch.Tensor:
    n = a.shape[-1]
    be = _resolve_facade(backend, "inverse", n)
    if be == "dd":
        r = _dd.inverse_dd_batched(a)
        return r.x_hi + r.x_lo
    if be == "pallas":
        return _kernels.inverse_batched(a)
    if be == "rbt":
        return _rbt.inverse_rbt_batched(a)
    if be == "blocked_pallas":
        x = _lub.blocked_inverse_batched(
            a, nb=_blocked_nb(n, "inverse"), panel_backend="pallas")
        return _like(x, a)
    if be in ("loop", "blocked"):
        # the reference's "blocked" inverse is its loop's too
        return _like(_solve.inverse_batched(a, tol=LOOP_INVERSE_TOL).inverse,
                     a)
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
        # the backward inverts A through the same backend: refuse now, not
        # after the forward
        raise ValueError(
            f"det at N={n} with a gradient on backend={backend!r}: its "
            f"backward needs that backend's inverse, which reaches N <= 167 "
            f"and multiples of 4 to 180 ('pallas') or N divisible by "
            f"min(64, N) ('blocked_pallas'); backend='auto' or 'loop' "
            f"inverts every N")
    if be == "blocked_pallas":
        return _like(_lub.pallas_det_batched(a, nb=_blocked_nb(n, "det")), a)
    if be == "blocked":
        return _like(_lub.blocked_det_batched(a), a)
    if be == "loop":
        return _like(_lu.det_lu_batched(a), a)
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
    ``_Det``; on ``"pallas"`` and ``"blocked_pallas"`` only where their
    inverse reaches."""
    return _Det.apply(a, backend)


def rank_batched(
    a: torch.Tensor, backend: str = "auto",
    tol: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched numerical rank of ``a [B, M, N]`` (int32).  ``tol`` is a
    per-matrix threshold ``[B]``; by default ``max(M, N)·100·eps·max|A|``
    (``gauss_jordan.default_rank_tol``), the library's own on ``"xla"``.
    ``"auto"``: kernel 3 to max(M, N) = 424, the blocked RREF past it."""
    if backend == "blocked_pallas":
        raise ValueError("rank_batched has no 'blocked_pallas' backend: LU "
                         "pivots do not reveal rank")
    if backend not in RANK_BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r} for rank; one of {RANK_BACKENDS}")
    s = max(a.shape[-2:])
    if backend == "pallas" or (backend == "auto"
                               and _kernels.supports("rank", s)):
        return _kernels.rank_batched(a, tol=tol)
    if backend == "xla":
        if tol is None:
            return torch.linalg.matrix_rank(a).to(torch.int32)
        return torch.linalg.matrix_rank(a, atol=tol, rtol=0.0).to(
            torch.int32)
    if backend in ("auto", "blocked") and s >= BLOCKED_RREF_MIN_N:
        return _rrb.rank_blocked_batched(a, tol=tol)
    return _solve.rank_batched(a, tol=tol)


def lu_factor_batched(a: torch.Tensor, backend: str = "auto"):
    """Batched LU with partial pivoting, ``P A = L U``, of ``a [B, N, N]``
    in f32.  ``"blocked_pallas"`` (``"auto"`` wherever ``min(64, N)``
    divides N): ``lu_blocked.blocked_lu_batched`` on panel kernel 6 with
    ``nb = min(64, N)`` (two-level panels where the kernel's shared
    memory needs them); ``"blocked"``: the same on the library's LU; both
    return ``BlockedLUResult(lu, perm, sign, ok, l11_inv, u11_inv)``.
    ``"loop"`` (``"auto"`` elsewhere): ``ops.lu.lu_factor_batched``'s
    ``LUResult(lu, perm, sign, ok)``, as the reference returns it."""
    if backend not in LU_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {LU_BACKENDS}")
    if backend == "pallas":
        raise NotImplementedError(
            "lu_factor has no 'pallas' op: the kernel facade (ops.kernels, "
            "the reference's ops.pallas) factors nothing; take "
            "'blocked_pallas', which runs panel kernel 6")
    n = a.shape[-1]
    if backend == "loop" or (backend == "auto" and not _blocked_ok(n)):
        return _lu.lu_factor_batched(a)
    if backend == "blocked":
        return _lub.blocked_lu_batched(
            a, nb=_blocked_nb(n, "lu_factor", backend), panel_backend="xla")
    return _lub.blocked_lu_batched(a, nb=_blocked_nb(n, "lu_factor"))


def affine_solve_batched(
    a: torch.Tensor, b: torch.Tensor, backend: str = "auto",
    tol: Optional[torch.Tensor] = None,
) -> _solve.BatchedAffineSubspace:
    """Solution sets of possibly singular or rectangular systems ``a [B,
    M, N] x = b [B, M]``, padded (``ops.solve.BatchedAffineSubspace``).
    Kernel 3 where the square-padded ``[s, s + 1]`` is in its big reach
    (``"auto"``, ``"pallas"``), the blocked RREF from max(M, N) = 256
    (``"auto"``, ``"blocked"``), else the loop with partial pivoting;
    all three give the same (unique) reduced row echelon form.  ``tol``:
    one threshold or one per matrix ``[B]``; by default
    ``100·max(M, N+1)·eps·max|[A|b]|`` per system."""
    if backend not in AFFINE_BACKENDS:
        raise ValueError(f"unknown backend {backend!r} for the affine "
                         f"solve; one of {AFFINE_BACKENDS}")
    m, n = a.shape[-2], a.shape[-1]
    if backend in ("auto", "pallas") and _solve.solve_affine_gj_supported(
            m, n):
        return _solve.solve_affine_gj_batched(a, b, tol=tol)
    if backend in ("auto", "blocked") and max(m, n) >= BLOCKED_RREF_MIN_N:
        return _rrb.solve_affine_blocked_batched(a, b, tol=tol)
    return _solve.solve_batched(a, b, tol=tol, pivot_rule="partial")


def nullspace_batched(
    a: torch.Tensor, backend: str = "auto",
    tol: Optional[torch.Tensor] = None,
) -> _solve.BatchedAffineSubspace:
    """Nullspaces of ``a [B, M, N]`` as affine subspaces through the
    origin (``affine_solve_batched`` with b = 0)."""
    b = torch.zeros(a.shape[0], a.shape[-2], dtype=a.dtype, device=a.device)
    return affine_solve_batched(a, b, backend=backend, tol=tol)
