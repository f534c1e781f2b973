"""Distributed Krylov solves of ONE large square system, row-sharded
(counterpart of ``linalg_solver_tpu.parallel.distributed_krylov``).

Every Krylov vector is replicated and only the matrix is sharded, which
keeps the communication minimal and fixed:

- matvec: a local ``[N/p, N] × [N]`` product, then ONE all-gather of the
  ``[N/p]`` pieces per operator application;
- every dot product and update runs redundantly on the replicated
  vectors, with no collective;
- so CG costs one all-gather an iteration, BiCGSTAB two, GMRES(m) one an
  Arnoldi step.

The iterations are ``ops.krylov``'s matrix-free cores (``cg_matvec``,
``bicgstab_matvec``, ``gmres_matvec``) unchanged, with the collective
folded into the matvec closure: the same per-lane freezing, true-residual
``converged`` flags and one host read of the stop flag a chunk, which
every rank takes alike since their vectors are equal.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.krylov import (
    KrylovResult,
    bicgstab_matvec,
    cg_matvec,
    gmres_matvec,
)
from ..utils.precision import f32_matmuls
from . import comm
from .mesh import axis_index, shard


def _local_matvec(a_loc, group):
    """Row-sharded operator on a replicated ``[1, N]`` vector: the local
    product and one tiled all-gather."""

    def mv(v):
        with f32_matmuls():
            y_loc = a_loc @ v[0]
        return comm.all_gather(y_loc, group, tiled=True)[None]

    return mv


def _local_jacobi(a_loc, row0: int, group):
    """Replicated ``1/diag(A)`` from the sharded rows (one all-gather,
    once)."""
    rows = a_loc.shape[0]
    i = torch.arange(rows, device=a_loc.device)
    d = comm.all_gather(a_loc[i, row0 + i], group, tiled=True)
    dinv = 1.0 / torch.clamp(d.abs(), min=torch.finfo(a_loc.dtype).tiny)
    return lambda v: dinv[None] * v


def _run(core, a, b, mesh, axis, precond, **kw) -> KrylovResult:
    f32 = torch.promote_types(a.dtype, torch.float32)
    group = mesh.get_group(axis)
    a_loc = shard(a.to(f32), mesh, axis)
    mv = _local_matvec(a_loc, group)
    M = (_local_jacobi(a_loc, axis_index(mesh, axis) * a_loc.shape[0], group)
         if precond else None)
    res = core(mv, b.to(f32)[None], precond=M, **kw)
    return KrylovResult(res.x[0], res.converged[0], res.iters,
                        res.resnorm[0])


def distributed_cg(
    a: torch.Tensor, b: torch.Tensor, mesh: DeviceMesh, axis: str = "dp",
    tol: Optional[float] = None, max_iters: int = 0, precond: bool = True,
) -> KrylovResult:
    """CG on ONE row-sharded SPD ``[N, N]`` system (x, b replicated; N must
    divide by the mesh axis size).  One all-gather an iteration."""
    return _run(cg_matvec, a, b, mesh, axis, precond,
                tol=tol, max_iters=max_iters)


def distributed_bicgstab(
    a: torch.Tensor, b: torch.Tensor, mesh: DeviceMesh, axis: str = "dp",
    tol: Optional[float] = None, max_iters: int = 0, precond: bool = True,
) -> KrylovResult:
    """BiCGSTAB on ONE row-sharded general square system."""
    return _run(bicgstab_matvec, a, b, mesh, axis, precond,
                tol=tol, max_iters=max_iters)


def distributed_gmres(
    a: torch.Tensor, b: torch.Tensor, mesh: DeviceMesh, axis: str = "dp",
    tol: Optional[float] = None, restart: int = 32, max_restarts: int = 16,
    precond: bool = True,
) -> KrylovResult:
    """GMRES(m) on ONE row-sharded general square system."""
    return _run(gmres_matvec, a, b, mesh, axis, precond,
                tol=tol, restart=restart, max_restarts=max_restarts)
