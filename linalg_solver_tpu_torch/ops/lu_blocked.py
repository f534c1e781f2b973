"""Pivoted batched solve and inverse, and the triangular inverses of the
RBT phase engine (counterpart of ``linalg_solver_tpu.ops.lu_blocked``).

Ported so far:

- ``blocked_solve_batched`` and ``blocked_inverse_batched``, the last
  rungs of the RBT solve's and inverse's rescues.  The JAX versions are
  plain XLA code (a blocked partial-pivoting LU), not Pallas kernels, so
  here they are the library's pivoted LU (plus f32 refinement for the
  solve).
- ``invert_unit_lower`` and ``invert_upper``: the same divide-and-conquer
  and Neumann-product math as the reference, in batched products, so
  that the phase engine's numbers track it.  Their products run at the
  caller's matmul precision, as the reference's run at its
  ``default_matmul_precision``.
"""

from __future__ import annotations

import torch

from ..utils.precision import f32_matmuls

#: below this size, triangular inverses use the Neumann product instead
#: of recursing (the reference's ``_NEUMANN_BASE``)
_NEUMANN_BASE = 64


def blocked_solve_batched(
    a: torch.Tensor, b: torch.Tensor, ir_steps: int = 2
) -> torch.Tensor:
    """Factor (partial pivoting) and solve ``a @ x = b`` for ``a [B, N, N]``
    and ``b [B, N]`` or ``[B, N, K]``, then ``ir_steps`` rounds of f32
    refinement against ``a``.  A singular system comes back non-finite;
    nothing raises."""
    vector_input = b.dim() == a.dim() - 1
    a32 = a.to(torch.float32)
    b3 = (b.unsqueeze(-1) if vector_input else b).to(torch.float32)
    lu, piv, _ = torch.linalg.lu_factor_ex(a32)
    x = torch.linalg.lu_solve(lu, piv, b3)
    with f32_matmuls():
        for _ in range(ir_steps):
            x = x + torch.linalg.lu_solve(lu, piv, b3 - a32 @ x)
    return x.squeeze(-1) if vector_input else x


def blocked_inverse_batched(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of ``a [B, N, N]`` in f32: pivoted LU, then the
    solve against I.  A singular matrix comes back non-finite."""
    a32 = a.to(torch.float32)
    lu, piv, _ = torch.linalg.lu_factor_ex(a32)
    eye = torch.eye(a32.shape[-1], dtype=torch.float32, device=a32.device)
    return torch.linalg.lu_solve(lu, piv, eye.expand_as(a32))


def _neumann_inv_unit(m: torch.Tensor) -> torch.Tensor:
    """Inverse of ``I + m`` for strictly triangular (nilpotent) ``m``:
    ``Π_j (I + (−m)^{2^j})``, exact after ``ceil(log2 n)`` factors."""
    n = m.shape[-1]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    p = -m
    acc = eye + p
    for _ in range(max((n - 1).bit_length(), 1) - 1):
        p = p @ p
        acc = acc + acc @ p
    return acc


def invert_unit_lower(lo: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched unit-lower-triangular ``[..., n, n]``: divide
    and conquer down to ``_NEUMANN_BASE``, then the Neumann product.
    ``[[A, 0], [C, B]]⁻¹ = [[A⁻¹, 0], [−B⁻¹ C A⁻¹, B⁻¹]]``."""
    n = lo.shape[-1]
    if n == 1:
        return torch.ones_like(lo)
    if n <= _NEUMANN_BASE:
        return _neumann_inv_unit(torch.tril(lo, -1))
    h = n // 2
    ai = invert_unit_lower(lo[..., :h, :h])
    bi = invert_unit_lower(lo[..., h:, h:])
    top = torch.cat([ai, torch.zeros_like(lo[..., :h, h:])], dim=-1)
    bottom = torch.cat([-(bi @ (lo[..., h:, :h] @ ai)), bi], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def invert_upper(up: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched upper-triangular ``[..., n, n]`` (non-unit
    diagonal): divide and conquer down to ``_NEUMANN_BASE``, then
    ``U = D (I + D⁻¹ strict(U))`` with the Neumann product."""
    n = up.shape[-1]
    if n == 1:
        return 1.0 / up
    if n <= _NEUMANN_BASE:
        d = torch.diagonal(up, dim1=-2, dim2=-1)
        k = torch.triu(up, 1) / d[..., :, None]
        return _neumann_inv_unit(k) / d[..., None, :]
    h = n // 2
    ai = invert_upper(up[..., :h, :h])
    ci = invert_upper(up[..., h:, h:])
    top = torch.cat([ai, -(ai @ (up[..., :h, h:] @ ci))], dim=-1)
    bottom = torch.cat([torch.zeros_like(up[..., h:, :h]), ci], dim=-1)
    return torch.cat([top, bottom], dim=-2)
