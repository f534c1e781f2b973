"""Device mesh construction and sharding helpers (counterpart of
``linalg_solver_tpu.parallel.mesh``), on ``torch.distributed``.

The scaling axes:

- ``dp``: data parallelism over the matrix batch; each rank owns a
  slice of ``[B, N, N]``, and the batch kernels need no communication;
- ``tp``: parallelism inside a matrix (the preconditioner's contraction
  dimension, the columns of one distributed matrix), reduced with
  collectives on the axis's process group.

The reference's ``shard_map`` body becomes what every rank of the
process group runs.  A ``("dp", "tp")`` mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the first ``dp·tp``
ranks of the world, rank ``i·tp + j`` at ``(i, j)`` (the reference's
``devices[:dp·tp].reshape(dp, tp)``); an axis's collectives go to
``mesh.get_group(axis)``.  The caller initializes the process group
(``nccl`` on cards, ``gloo`` on the CPU); nothing here starts one.

A distributed function takes the global input, the same tensor on every
rank, and slices its own shard by its mesh coordinate; the placement
specs below name those slicings as the reference's ``PartitionSpec``s
do: a tuple with one entry a tensor axis, an axis name where that axis
is split over the mesh axis, ``None`` where it is whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def default_device(device=None) -> torch.device:
    """``device``, or the CUDA device when it is None (which must be
    there: the mesh runs on cards unless a caller asks for the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh runs on CUDA devices and there is none; "
                           "pass device='cpu' for the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A 2-axis ``("dp", "tp")`` mesh over the first ``dp·tp`` ranks of the
    initialized process group.  ``dp`` defaults to ``world // tp``;
    ``device_type`` to ``"cuda"``.  Every rank of the world calls it (the
    axis groups are made collectively); a rank outside the mesh gets a
    mesh whose ``get_coordinate()`` is None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if dp is None:
        if world % tp:
            raise ValueError(f"{world} devices not divisible by tp={tp}")
        dp = world // tp
    if dp * tp > world:
        raise ValueError(
            f"mesh {dp}x{tp} needs {dp * tp} devices, have {world}")
    if device_type is None:
        device_type = default_device().type
    grid = torch.arange(dp * tp).reshape(dp, tp)
    return DeviceMesh(device_type, grid, mesh_dim_names=("dp", "tp"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    return coord[mesh.mesh_dim_names.index(axis)]


def batch_spec() -> Tuple:
    """Batch-of-matrices placement: batch over dp, matrices whole."""
    return ("dp", None, None)


def batch_vec_spec() -> Tuple:
    return ("dp", None)


def replicated_spec(ndim: int) -> Tuple:
    return (None,) * ndim


def shard(x: torch.Tensor, mesh: DeviceMesh, axes, dim: int = 0
          ) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``, split over the
    mesh axes ``axes`` (a name or a tuple of names, the first the most
    significant, as a ``PartitionSpec`` entry ``("dp", "tp")``)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    count, idx = 1, 0
    for ax in axes:
        size = axis_size(mesh, ax)
        idx = idx * size + axis_index(mesh, ax)
        count *= size
    n = x.shape[dim]
    if n % count:
        raise ValueError(f"axis {dim} of length {n} not divisible by the "
                         f"{count} ranks of {axes}")
    step = n // count
    return x.narrow(dim, idx * step, step)


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's slice of a ``[B, ...]`` tensor, its batch axis split
    over dp (the same slice on every tp rank)."""
    return shard(x, mesh, "dp")


def replicate(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The mesh's first rank's ``x`` on every rank of the mesh: a broadcast
    along tp from it, then along dp from each rank of its dp row."""
    out = x.contiguous().clone()
    if axis_index(mesh, "dp") == 0:
        g = mesh.get_group("tp")
        dist.broadcast(out, src=dist.get_global_rank(g, 0), group=g)
    g = mesh.get_group("dp")
    dist.broadcast(out, src=dist.get_global_rank(g, 0), group=g)
    return out
