"""Distributed single-matrix LU: column-block-cyclic blocked LU with
partial pivoting over one mesh axis (counterpart of
``linalg_solver_tpu.parallel.distributed_lu``).

The batch paths (``ops.lu_blocked``) scale by sharding the batch: each
rank factors whole matrices.  This module scales the other axis: ONE
matrix is factored across the ranks of a mesh axis, ScaLAPACK-style:

- **Layout**: columns are sharded block-cyclically, rank ``d`` owning
  the column blocks ``{j : j mod D == d}`` of width ``nb``.  Rows are
  never sharded, so the pivot search down a column and the row swaps
  stay local.
- **Per phase j**: the owner's ``[N, nb]`` panel reaches every rank by
  ONE masked all-reduce (``comm.psum``, the only communication), every
  rank factors it redundantly (``ops.lu_blocked._panel_factor``, the
  reference's pivot rule), applies the phase's row permutation to its
  local columns and runs the trailing update ``A22 −= L21 (L11⁻¹ A12)``
  on its own columns, with the finished blocks (global block ≤ j) masked
  out, as the reference does.
- **Solve**: block forward and back substitution over the sharded
  factor: per block one ``[nb, nb]`` diagonal-block all-reduce and one
  masked all-reduce of the owner's column-block contribution.

The phase and step loops are Python loops of batched torch operations
(the panel's steps are small ops on one ``[N − k0, nb]`` panel each).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.lu_blocked import _panel_factor, invert_unit_lower, invert_upper
from ..utils.precision import f32_matmuls
from . import comm
from .mesh import axis_index, axis_size


def cyclic_column_order(n: int, nb: int, d_axis: int) -> torch.Tensor:
    """Global column indices in shard order: rank 0's blocks (j = 0, D,
    2D, …), then rank 1's (j = 1, D+1, …), …  ``a[:, order]`` is the
    array to shard contiguously over the axis."""
    m = n // nb
    idx = []
    for d in range(d_axis):
        for j in range(d, m, d_axis):
            idx.extend(range(j * nb, (j + 1) * nb))
    return torch.tensor(idx, dtype=torch.int64)


def _inverse_order(order: torch.Tensor) -> torch.Tensor:
    return torch.argsort(order)


class DistributedLUResult(NamedTuple):
    lu_sharded: torch.Tensor  # [N, N/D] this rank's packed L\U columns,
    #                           in cyclic-shard column order
    perm: torch.Tensor        # [N] replicated: row i of PA = row perm[i]
    sign: torch.Tensor        # [] permutation parity
    ok: torch.Tensor          # [] every pivot nonzero


def _check_args(n: int, nb: int, d_axis: int) -> None:
    if n % (nb * d_axis):
        raise ValueError(
            f"N={n} must be divisible by nb*D = {nb}*{d_axis}"
        )


def default_block(n: int, d_axis: int) -> int:
    """Largest power-of-two block width <= 128 giving each device at
    least one block."""
    nb = min(128, n // d_axis)
    while n % (nb * d_axis):
        nb //= 2
        if nb < 1:
            raise ValueError(f"no valid block width for N={n}, D={d_axis}")
    return nb


def _lu_local(a_loc: torch.Tensor, n: int, nb: int, d_axis: int, d: int,
              group, tol: float):
    """Factor the local column blocks in place (the reference's
    ``shard_map`` body)."""
    m = n // nb
    dtype, dev = a_loc.dtype, a_loc.device
    gblock = d + (torch.arange(n // d_axis, device=dev) // nb) * d_axis
    perm = torch.arange(n, dtype=torch.int32, device=dev)
    sign = torch.ones((), dtype=dtype, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    eye = torch.eye(nb, dtype=dtype, device=dev)
    a_loc = a_loc.clone()
    for j in range(m):
        owner, lb = j % d_axis, j // d_axis
        k0 = j * nb
        is_owner = float(d == owner)
        cols = slice(lb * nb, (lb + 1) * nb)
        # ONE collective: the owner's [N, nb] panel to every rank
        panel = comm.psum(a_loc[:, cols] * is_owner, group)
        sub_f, local_perm, psign, pok = _panel_factor(
            panel[None, k0:], 0, nb, torch.arange(n - k0, device=dev),
            tol)
        sub_f, local_perm = sub_f[0], local_perm[0].long()
        sign = sign * psign[0]
        ok = ok & pok[0]
        a_loc[k0:] = a_loc[k0:].index_select(0, local_perm)
        perm[k0:] = perm[k0:].index_select(0, local_perm)
        if d == owner:
            a_loc[k0:, cols] = sub_f
        if j + 1 < m:
            L11 = torch.tril(sub_f[:nb], -1) + eye
            L21 = sub_f[nb:]
            right = (gblock > j).to(dtype)[None, :]
            A12 = a_loc[k0:k0 + nb]
            U12 = (invert_unit_lower(L11) @ A12) * right
            a_loc[k0:k0 + nb] = U12 + A12 * (1 - right)
            a_loc[k0 + nb:] -= L21 @ U12
    return a_loc, perm, sign, ok


def _diag_blocks(lu_loc, n, nb, d_axis, d, group):
    """The ``m`` diagonal ``[nb, nb]`` blocks, each all-reduced from its
    owner."""
    out = []
    for j in range(n // nb):
        owner, lb = j % d_axis, j // d_axis
        blk = lu_loc[j * nb:(j + 1) * nb, lb * nb:(lb + 1) * nb]
        out.append(comm.psum(blk * float(d == owner), group))
    return out


def _solve_local(lu_loc, perm, b, n, nb, d_axis, d, group):
    """Block substitution over the cyclic-sharded factor; ``b [N, K]``
    replicated, the solution replicated."""
    m = n // nb
    dtype = lu_loc.dtype
    diags = _diag_blocks(lu_loc, n, nb, d_axis, d, group)
    eye = torch.eye(nb, dtype=dtype, device=lu_loc.device)

    z = b.index_select(0, perm.long())
    ys = []
    for j in range(m):
        owner, lb = j % d_axis, j // d_axis
        k0 = j * nb
        y_j = invert_unit_lower(torch.tril(diags[j], -1) + eye) @ z[k0:k0 + nb]
        ys.append(y_j)
        if j + 1 < m:
            below = lu_loc[k0 + nb:, lb * nb:(lb + 1) * nb]
            contrib = comm.psum((below @ y_j) * float(d == owner), group)
            z = torch.cat([z[:k0 + nb], z[k0 + nb:] - contrib])

    xs = [None] * m
    zz = torch.cat(ys)
    for j in reversed(range(m)):
        owner, lb = j % d_axis, j // d_axis
        k0 = j * nb
        x_j = invert_upper(torch.triu(diags[j])) @ zz[k0:k0 + nb]
        xs[j] = x_j
        if j > 0:
            above = lu_loc[:k0, lb * nb:(lb + 1) * nb]
            contrib = comm.psum((above @ x_j) * float(d == owner), group)
            zz = torch.cat([zz[:k0] - contrib, zz[k0:]])
    return torch.cat(xs)


def _setup(a, mesh, axis, nb):
    n = a.shape[-1]
    d_axis = axis_size(mesh, axis)
    nb = nb or default_block(n, d_axis)
    _check_args(n, nb, d_axis)
    return n, d_axis, nb, axis_index(mesh, axis), mesh.get_group(axis)


@f32_matmuls()
def distributed_lu(
    a: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    nb: Optional[int] = None,
    tol: float = 0.0,
) -> DistributedLUResult:
    """Factor ``P A = L U`` for one ``[N, N]`` matrix (the same tensor on
    every rank) column-sharded over ``mesh[axis]``.  Returns this rank's
    packed factor columns in cyclic order (``cyclic_column_order``), the
    row permutation, parity and ok."""
    n, d_axis, nb, d, group = _setup(a, mesh, axis, nb)
    order = cyclic_column_order(n, nb, d_axis).to(a.device)
    w = n // d_axis
    a_loc = a.index_select(1, order[d * w:(d + 1) * w])
    return DistributedLUResult(
        *_lu_local(a_loc, n, nb, d_axis, d, group, tol))


@f32_matmuls()
def distributed_solve(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    nb: Optional[int] = None,
    tol: float = 0.0,
) -> torch.Tensor:
    """Solve ``a @ x = b`` (``b: [N]`` or ``[N, K]``) for one matrix
    sharded over ``mesh[axis]``.  ``x`` is returned replicated."""
    n, d_axis, nb, d, group = _setup(a, mesh, axis, nb)
    vector_input = b.ndim == 1
    if vector_input:
        b = b[:, None]
    res = distributed_lu(a, mesh, axis=axis, nb=nb, tol=tol)
    x = _solve_local(res.lu_sharded, res.perm, b.to(res.lu_sharded.dtype),
                     n, nb, d_axis, d, group)
    return x[:, 0] if vector_input else x


@f32_matmuls()
def distributed_det(
    a: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    nb: Optional[int] = None,
    tol: float = 0.0,
) -> torch.Tensor:
    """Determinant of one mesh-sharded matrix: product of the sharded U
    diagonal (one masked all-reduce a block) × permutation parity."""
    n, d_axis, nb, d, group = _setup(a, mesh, axis, nb)
    res = distributed_lu(a, mesh, axis=axis, nb=nb, tol=tol)
    parts = []
    for j in range(n // nb):
        owner, lb = j % d_axis, j // d_axis
        blk = res.lu_sharded[j * nb:(j + 1) * nb, lb * nb:(lb + 1) * nb]
        parts.append(comm.psum(torch.diagonal(blk) * float(d == owner),
                               group))
    det_u = torch.prod(torch.cat(parts))
    return torch.where(res.ok, res.sign * det_u, 0.0)


def gather_packed_lu(res: DistributedLUResult, nb: int, d_axis: int,
                     group=None) -> torch.Tensor:
    """Undo the cyclic column order: the packed L\\U in natural column
    order.  ``res.lu_sharded`` is a rank's ``[N, N/D]`` shard, gathered
    over the axis's ``group`` first (``mesh.get_group(axis)``), or the
    ``[N, N]`` concatenation of every rank's shards."""
    lu = res.lu_sharded
    n = lu.shape[0]
    if lu.shape[1] != n:
        if group is None:
            raise ValueError("a shard of the factor needs its axis's group "
                             "to be gathered")
        lu = torch.cat(list(comm.all_gather(lu, group)), dim=1)
    order = cyclic_column_order(n, nb, d_axis).to(lu.device)
    return lu[:, _inverse_order(order)]
