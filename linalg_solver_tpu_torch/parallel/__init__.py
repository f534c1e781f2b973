"""Mesh layer on ``torch.distributed``: dp (batch) × tp (within a matrix)
scaling over the ranks of a process group (counterpart of
``linalg_solver_tpu.parallel``).

Single-matrix scale-out lives in the submodules: ``distributed_lu``
(square solves, column-block-cyclic), ``distributed_dd`` (its float64-
class refinement), ``distributed_tall`` (tall QR, least squares, polar,
SVD, one ``[n, n]`` all-reduce a pass), ``distributed_krylov``
(row-sharded CG, BiCGSTAB, GMRES) and ``distributed_eigh`` (symmetric
eigendecomposition and SVD by block Jacobi over a ring of ranks);
``comm`` meters their collectives against analytic models."""

from .distributed_eigh import (
    DistributedEigh,
    DistributedSVDJacobi,
    distributed_eigh,
    distributed_svd_jacobi,
)
from .mesh import (
    batch_spec,
    batch_vec_spec,
    make_mesh,
    replicate,
    replicated_spec,
    shard_batch,
)
from .distributed_krylov import (
    distributed_bicgstab,
    distributed_cg,
    distributed_gmres,
)
from .distributed_tall import (
    DistributedPolar,
    DistributedQR,
    DistributedRSVD,
    DistributedSVD,
    distributed_cholqr2,
    distributed_lstsq,
    distributed_polar_tall,
    distributed_randomized_svd,
    distributed_svd_tall,
)

__all__ = [
    "make_mesh",
    "batch_spec",
    "batch_vec_spec",
    "replicated_spec",
    "shard_batch",
    "replicate",
    "DistributedQR", "DistributedPolar", "DistributedSVD",
    "DistributedRSVD",
    "distributed_cholqr2", "distributed_lstsq",
    "distributed_polar_tall", "distributed_svd_tall",
    "distributed_randomized_svd",
    "distributed_cg", "distributed_bicgstab", "distributed_gmres",
    "DistributedEigh", "distributed_eigh",
    "DistributedSVDJacobi", "distributed_svd_jacobi",
]
