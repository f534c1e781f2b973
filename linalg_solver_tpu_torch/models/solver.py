"""The batched linear-system solver's production entry point and the
preconditioner training step (counterpart of
``linalg_solver_tpu.models.solver``).

``BatchedSolver`` routes each method through ``ops.dispatch`` with one
backend: LU factor and solve, Gauss–Jordan inverse, determinant, rank,
the affine solve of singular or rectangular systems, and
``solve_checked``, the solve with its residual check, whose failed
systems a caller retries through ``affine_solve`` (as the reference's
``examples/serving_pipeline.py`` does); and, as the reference's methods
do, ``lstsq`` (``ops.lstsq``), ``svd`` (``ops.svd``), ``rcond``
(``ops.cond``) and ``det_exact`` (``ops.exact_int``), which take no
backend.

With a mesh (``parallel.mesh.make_mesh``), ``solve``, ``inverse``,
``det`` and ``rank`` run batch-sharded: every rank takes its slice of
the batch over ``batch_shard_axes`` and runs the whole dispatch stack,
kernels included, on it, with zero collectives (every lane is an
independent system), and returns that slice.

``make_training_step`` learns an approximate-inverse preconditioner
``M ≈ A⁻¹`` by gradient descent on ``‖A (M b) − b‖²`` over a
``("dp", "tp")`` mesh: the batch over dp, M's columns over tp.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import dispatch
from ..ops.cond import rcond_batched
from ..ops.exact_int import bareiss_batched
from ..ops.lstsq import lstsq_batched
from ..ops.svd import svd_batched
from ..parallel import comm
from ..parallel.mesh import axis_index, axis_size, default_device, shard
from ..utils.precision import f32_matmuls


# ---------------------------------------------------------------------------
# Batch-sharded execution: each rank runs the full dispatch stack, fused
# kernels included, on its slice of the batch.  The solve moves ZERO
# collective bytes (every lane is an independent system).
# ---------------------------------------------------------------------------

_BATCH_OPS = {
    "solve": dispatch.solve_batched,
    "inverse": dispatch.inverse_batched,
    "det": dispatch.det_batched,
    "rank": dispatch.rank_batched,
}


def batch_shard_axes(mesh: DeviceMesh, batch: int) -> Tuple[str, ...]:
    """Longest prefix of the mesh's axis names whose device product divides
    ``batch``: all axes when possible, so a pure-batch workload uses every
    rank of a (dp, tp) mesh rather than repeating its work over tp."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(int(s) for s in mesh.mesh.shape)
    for k in range(len(names), 0, -1):
        if batch % math.prod(sizes[:k]) == 0:
            return names[:k]
    raise ValueError(
        f"batch {batch} not divisible by any mesh-axis prefix of "
        f"{dict(zip(names, sizes))} — pad the batch to a multiple of "
        f"{sizes[0]} (axis {names[0]!r})"
    )


class BatchedSolver:
    """High-level batched dense solver.  Every method takes a batch ``[B,
    N, N]`` (``affine_solve`` and ``rank`` also ``[B, M, N]``) on the
    device it runs on.

    With a ``mesh`` (a ``DeviceMesh`` from ``parallel.mesh.make_mesh``),
    ``solve``, ``inverse``, ``det`` and ``rank`` take the global batch
    (the same on every rank) and return this rank's slice of the result
    over ``batch_shard_axes(mesh, B)``, with no collective; the other
    methods run unsharded."""

    def __init__(self, mesh: Optional[DeviceMesh] = None,
                 backend: str = "auto"):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh "
                            f"(parallel.mesh.make_mesh), not "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.backend = backend

    def _run(self, op: str, a: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.mesh is not None:
            axes = batch_shard_axes(self.mesh, a.shape[0])
            a = shard(a, self.mesh, axes)
            b = None if b is None else shard(b, self.mesh, axes)
        args = (a,) if b is None else (a, b)
        return _BATCH_OPS[op](*args, backend=self.backend)

    def solve(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Unique solutions of square systems: ``a [B, N, N]``, ``b [B, N]``
        or ``[B, N, k]``; batch-sharded over the mesh when one was
        given."""
        return self._run("solve", a, b)

    def factor(self, a: torch.Tensor):
        return dispatch.lu_factor_batched(a, backend=self.backend)

    def inverse(self, a: torch.Tensor) -> torch.Tensor:
        return self._run("inverse", a)

    def det(self, a: torch.Tensor) -> torch.Tensor:
        return self._run("det", a)

    def rank(self, a: torch.Tensor) -> torch.Tensor:
        return self._run("rank", a)

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


# ---------------------------------------------------------------------------
# Preconditioner training (the multi-device "training step")
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: torch.Tensor   # [n, n] preconditioner M, the same on every rank
    step: torch.Tensor     # [] int32


def init_train_state(n: int, dtype: torch.dtype = torch.float32,
                     device=None) -> TrainState:
    """``M = I``, step 0, on ``device`` (None: the CUDA device, which must
    be there)."""
    device = default_device(device)
    return TrainState(torch.eye(n, dtype=dtype, device=device),
                      torch.zeros((), dtype=torch.int32, device=device))


class _TPSum(torch.autograd.Function):
    """The tp reduction inside the loss: forward an all-reduce over tp,
    backward the identity.  The loss downstream is the same on every tp
    rank, so each rank's cotangent of the sum is already the full one;
    summing it again over tp (what the transpose of the reference's
    ``psum`` does) would make the gradient tp times too large."""

    @staticmethod
    def forward(ctx, x, group):
        return comm.psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _residual_loss_tp(params_shard, a, b, tp_idx, tp_group):
    """Per-dp-rank loss with the preconditioner's contraction dimension
    over tp: ``x = M b`` is the tp sum of the partial products of M's
    local columns with the matching entries of b."""
    w = params_shard.shape[1]
    b_shard = b[:, tp_idx * w:(tp_idx + 1) * w]
    x = _TPSum.apply(b_shard @ params_shard.T, tp_group)     # [B_loc, n]
    resid = (a @ x[:, :, None])[:, :, 0] - b
    return 0.5 * (resid * resid).sum(dim=-1).mean()


def make_training_step(mesh: DeviceMesh, lr: float = 1e-3):
    """The mesh-sharded training step ``step(state, a, b) -> (state,
    loss)``.

    Every rank passes the global ``a [B, n, n]``, ``b [B, n]`` and the
    replicated state; it takes its batch slice over dp and M's columns over
    tp, differentiates the loss on its column shard, averages the gradient
    and the loss over dp (all-reduce) and the loss over tp, updates its
    columns and all-gathers them over tp, so the new state is replicated.
    The step is layout-invariant: every ``(dp, tp)`` gives the step of one
    device (the reference's gradient at tp > 1 is tp times that one; see
    ``_TPSum``)."""
    dp_group, tp_group = mesh.get_group("dp"), mesh.get_group("tp")
    dp, tp = axis_size(mesh, "dp"), axis_size(mesh, "tp")

    def training_step(state: TrainState, a: torch.Tensor, b: torch.Tensor):
        tp_idx = axis_index(mesh, "tp")
        with f32_matmuls():
            p_loc = shard(state.params, mesh, "tp", dim=1).detach()
            p_loc.requires_grad_(True)
            with torch.enable_grad():
                loss = _residual_loss_tp(p_loc, shard(a, mesh, "dp"),
                                         shard(b, mesh, "dp"), tp_idx,
                                         tp_group)
                (grad,) = torch.autograd.grad(loss, p_loc)
            grad = comm.psum(grad, dp_group) / dp
            loss = comm.psum(loss.detach(), dp_group) / dp
            loss = comm.psum(loss, tp_group) / tp
            new_loc = p_loc.detach() - lr * grad
            params = (new_loc if tp == 1 else
                      torch.cat(list(comm.all_gather(new_loc, tp_group)),
                                dim=1))
        return TrainState(params, state.step + 1), loss

    return training_step
