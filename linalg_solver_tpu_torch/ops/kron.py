"""Kronecker-structured linear algebra: ``A ⊗ B`` and ``A ⊕ B`` without
materializing the big matrix (counterpart of
``linalg_solver_tpu.ops.kron``).

With row-major ``vec`` (``x = ravel(X)``):

    (A ⊗ B) vec(X) = vec(A X Bᵀ),   (A ⊗ B)⁻¹ = A⁻¹ ⊗ B⁻¹,
    (A ⊗ B)⁺ = A⁺ ⊗ B⁺,   (A ⊕ B) vec(X) = vec(A X + X Bᵀ),

so O((mn)³) work on the product becomes O(m³ + n³) on the factors: two
``dispatch.solve_batched(backend="xla")`` solves, two ``lstsq_batched``
passes, or one Sylvester equation (``sylvester_batched``, on the Schur
kernels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from . import dispatch
from .lstsq import lstsq_batched
from .sylvester import sylvester_batched


def kron_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Materialized ``A ⊗ B`` ``[B, m·n, p·q]`` (tests and small
    factors)."""
    B, m, p = a.shape
    _, n, q = b.shape
    return torch.einsum("bij,bkl->bikjl", a, b).reshape(B, m * n, p * q)


def _vec_rhs(c: torch.Tensor):
    vec = c.dim() == 2
    C = c[..., None] if vec else c
    return vec, C, C.shape[-1]


@f32_matmuls()
def kron_matvec_batched(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
    """``(A ⊗ B) x`` for ``a [B, m, p]``, ``b [B, n, q]``, ``x [B, p·q]``
    or ``[B, p·q, k]``: two products."""
    B, m, p = a.shape
    _, n, q = b.shape
    vec, X, k = _vec_rhs(x)
    X = X.reshape(B, p, q, k)
    Y = torch.einsum("bij,bjqk->biqk", a, X)
    Y = torch.einsum("blq,biqk->bilk", b, Y)
    out = Y.reshape(B, m * n, k)
    return out[..., 0] if vec else out


def kron_solve_batched(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Solve ``(A ⊗ B) x = c`` (``a [B, m, m]``, ``b [B, n, n]``, ``c
    [B, m·n]`` or ``[B, m·n, k]``) as ``X = A⁻¹ C̃ B⁻ᵀ``: two solves of
    ``dispatch.solve_batched(backend="xla")``, differentiable through
    it."""
    B, m, _ = a.shape
    _, n, _ = b.shape
    vec, C, k = _vec_rhs(c)
    Y = dispatch.solve_batched(a, C.reshape(B, m, n * k), backend="xla")
    Y = Y.reshape(B, m, n, k).transpose(1, 2).reshape(B, n, m * k)
    Z = dispatch.solve_batched(b, Y, backend="xla")
    Z = Z.reshape(B, n, m, k).transpose(1, 2).reshape(B, m * n, k)
    return Z[..., 0] if vec else Z


def kron_lstsq_batched(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Least-squares / minimum-norm solve of ``(A ⊗ B) x ≈ c`` for
    full-rank rectangular factors (``a [B, ma, na]``, ``b [B, mb, nb]``,
    ``c [B, ma·mb]``): two ``lstsq_batched`` passes.  Returns ``(x,
    ok)``."""
    B, ma, na = a.shape
    _, mb, nb = b.shape
    vec, C, k = _vec_rhs(c)
    r1 = lstsq_batched(a, C.reshape(B, ma, mb * k))
    Y = r1.x.reshape(B, na, mb, k).transpose(1, 2).reshape(B, mb, na * k)
    r2 = lstsq_batched(b, Y)
    Z = r2.x.reshape(B, nb, na, k).transpose(1, 2).reshape(B, na * nb, k)
    return (Z[..., 0] if vec else Z), r1.ok & r2.ok


class KronSumResult(NamedTuple):
    x: torch.Tensor   # [B, m·n] (or [B, m·n, 1])
    ok: torch.Tensor  # [B] the Sylvester solve was clean and x reproduces c


def kronsum_solve_batched(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                          ) -> KronSumResult:
    """Solve ``(A ⊕ B) x = c = (A ⊗ Iₙ + Iₘ ⊗ B) x`` through the Sylvester
    equation ``A X + X Bᵀ = C`` (one Schur pass a factor).  ``ok`` also
    gates on the true equation residual relative to ‖C‖ (not ‖X‖: a
    near-singular pencil's huge X cancels in A X + X Bᵀ): the returned x
    reproduces c to 1e-3."""
    B, m, _ = a.shape
    _, n, _ = b.shape
    vec, C, k = _vec_rhs(c)
    if k != 1:
        raise ValueError(f"kronsum_solve supports one right-hand side per "
                         f"lane (got k={k}); fold extra RHS into the batch.")
    Cm = C.reshape(B, m, n)
    res = sylvester_batched(a, b.transpose(1, 2), Cm)
    with f32_matmuls():
        r = a @ res.X + res.X @ b.transpose(1, 2) - Cm
    cnorm = torch.clamp(Cm.abs().amax(dim=(1, 2)), min=1e-30)
    resid_ok = r.abs().amax(dim=(1, 2)) <= 1e-3 * cnorm
    x = res.X.reshape(B, m * n, 1)
    return KronSumResult(x[..., 0] if vec else x, res.ok & resid_ok)
