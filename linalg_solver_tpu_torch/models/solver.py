"""The batched linear-system solver's production entry point
(counterpart of ``linalg_solver_tpu.models.solver``), on one GPU.

``BatchedSolver`` routes each method through ``ops.dispatch`` with one
backend: LU factor and solve, Gauss–Jordan inverse, determinant, rank,
the affine solve of singular or rectangular systems, and
``solve_checked``, the solve with its residual check, whose failed
systems a caller retries through ``affine_solve`` (as the reference's
``examples/serving_pipeline.py`` does); and, as the reference's methods
do, ``lstsq`` (``ops.lstsq``), ``svd`` (``ops.svd``), ``rcond``
(``ops.cond``) and ``det_exact`` (``ops.exact_int``), which take no
backend.

Not ported, and refused rather than sent to another solver: the device
mesh (``mesh=``; the reference's ``batch_shard_axes``,
``_sharded_batch_op`` and ``preconditioner_training_step``, ROADMAP.md
queue 1 item 13).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import dispatch
from ..ops.cond import rcond_batched
from ..ops.exact_int import bareiss_batched
from ..ops.lstsq import lstsq_batched
from ..ops.svd import svd_batched
from ..utils.precision import f32_matmuls


class BatchedSolver:
    """High-level batched dense solver on one device.  Every method takes
    a batch ``[B, N, N]`` (``affine_solve`` and ``rank`` also ``[B, M,
    N]``) on the device it runs on."""

    def __init__(self, mesh: Optional[object] = None, backend: str = "auto"):
        if mesh is not None:
            raise NotImplementedError(
                "BatchedSolver.mesh (batch sharding over devices) is not "
                "ported yet (ROADMAP.md queue 1 item 13)")
        self.mesh = None
        self.backend = backend

    def solve(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Unique solutions of square systems: ``a [B, N, N]``, ``b [B, N]``
        or ``[B, N, k]``."""
        return dispatch.solve_batched(a, b, backend=self.backend)

    def factor(self, a: torch.Tensor):
        return dispatch.lu_factor_batched(a, backend=self.backend)

    def inverse(self, a: torch.Tensor) -> torch.Tensor:
        return dispatch.inverse_batched(a, backend=self.backend)

    def det(self, a: torch.Tensor) -> torch.Tensor:
        return dispatch.det_batched(a, backend=self.backend)

    def rank(self, a: torch.Tensor) -> torch.Tensor:
        return dispatch.rank_batched(a, backend=self.backend)

    def affine_solve(self, a: torch.Tensor, b: torch.Tensor):
        """Solution sets of general (possibly singular or rectangular)
        systems, as ``ops.solve.BatchedAffineSubspace``."""
        return dispatch.affine_solve_batched(a, b, backend=self.backend)

    def solve_checked(self, a: torch.Tensor, b: torch.Tensor,
                      rel_tol: float = 1e-3):
        """Solve and verify: ``(x, relative_residuals, ok_mask)``, the
        residual ``‖A x − b‖ / (‖b‖ + 1e-30)`` in float32 (full float32
        products), ``ok`` where it is below ``rel_tol`` (a NaN residual is
        not ok).  A result is trusted only where its check passes."""
        x = self.solve(a, b)
        with f32_matmuls():
            r = (a @ x[..., None])[..., 0] - b
        rel = torch.linalg.vector_norm(r, dim=-1) / (
            torch.linalg.vector_norm(b, dim=-1) + 1e-30)
        return x, rel, rel < rel_tol

    def lstsq(self, a: torch.Tensor, b: torch.Tensor):
        """Least-squares / minimum-norm solve of full-rank rectangular
        batches (``ops.lstsq``)."""
        return lstsq_batched(a, b)

    def svd(self, a: torch.Tensor):
        """Thin SVD (QDWH polar + eigh, ``ops.svd``)."""
        return svd_batched(a)

    def rcond(self, a: torch.Tensor) -> torch.Tensor:
        """[B] reciprocal 1-norm condition estimate (``ops.cond``), the
        trust gate: a solve carries ~``-log10(eps/rcond)`` digits."""
        return rcond_batched(a)

    def det_exact(self, a_int: torch.Tensor):
        """Bit-exact integer determinants and ranks (Bareiss fraction-free
        elimination in int32); see ``ops.exact_int`` for the overflow
        contract."""
        return bareiss_batched(a_int)
