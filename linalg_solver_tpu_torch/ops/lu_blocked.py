"""Pivoted batched solve (counterpart of ``linalg_solver_tpu.ops.lu_blocked``).

Only ``blocked_solve_batched`` is ported so far: it is the last rung of
the RBT solve's rescue.  The JAX version is plain XLA code (a blocked
partial-pivoting LU), not a Pallas kernel, so here it is the library's
pivoted LU plus f32 iterative refinement.
"""

from __future__ import annotations

import torch

from ..utils.precision import f32_matmuls


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
