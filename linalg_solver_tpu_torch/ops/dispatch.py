"""Backend dispatch for the batched solve (counterpart of
``linalg_solver_tpu.ops.dispatch``).

Backends:

- ``"rbt"``  — random-butterfly pivot-free solve through the fused
  kernel, with the lane-compacted rescue (``ops.rbt.solve_rbt_batched``).
- ``"xla"``  — the library's ``torch.linalg.solve``: the named baseline
  (the JAX package's ``"xla"`` is ``jnp.linalg.solve``).
- ``"auto"`` — ``"rbt"`` where the fused kernel reaches (even N, at most
  ``MAX_K_RHS`` RHS columns, and its shared memory within a block's;
  ``kernels.solve_fused.fits``), on every device alike.  No other route
  is ported yet, so any other shape raises instead of quietly going to
  another solver.

The JAX package's TPU routing constants (``_XLA_CROSSOVER_N``,
``_RBT_SOLVE_MIN_N``, ``lanes_util_ok``) are TPU measurements and are
not carried over; a route is added here when the H100 measures it.
"""

from __future__ import annotations

import torch

from . import rbt as _rbt
from .kernels.solve_fused import MAX_K_RHS, fits
from ..utils.precision import f32_matmuls

BACKENDS = ("auto", "rbt", "xla")


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
