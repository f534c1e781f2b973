"""Distributed extended-precision solve: a float64-class backward error
for ONE mesh-sharded system (counterpart of
``linalg_solver_tpu.parallel.distributed_dd``).

One column-block-cyclic distributed LU (``distributed_lu``, one
all-reduce a phase) in float32, then refinement: each rank computes the
residual ``b − A(x_hi + x_lo)`` of its own contiguous block of rows in
float64, with no communication (a row's dot product never crosses
ranks), the residual's blocks are all-gathered (one collective a round)
and the float32 correction goes through the sharded factor like any
right-hand side.

The reference evaluates the row-local residual with Ozaki slice GEMMs
in float-float arithmetic (``ops.dd``'s ``dd_add_f32``,
``matmul_sliced_dd``, ``slice_cols``, ``slice_rows``), emulating
float64 on a chip without it; the port's ``ops.dd`` works in native
float64 and has none of them, so the residual here is a float64 product
of the float32 operands, and ``x = x_hi + x_lo`` is carried in float64
and returned as the float32 pair.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..utils.precision import f32_matmuls
from . import comm
from .distributed_lu import _setup, _solve_local, distributed_lu
from .mesh import shard

_F32, _F64 = torch.float32, torch.float64


class DistributedDDSolve(NamedTuple):
    x_hi: torch.Tensor   # [N] replicated
    x_lo: torch.Tensor   # [N]
    resid: torch.Tensor  # scalar: last float64 residual's max-norm
    ok: torch.Tensor     # scalar


@f32_matmuls()
def distributed_solve_dd(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    nb: Optional[int] = None,
    iters: int = 4,
) -> DistributedDDSolve:
    """Solve one ``[N, N]`` system sharded over ``mesh[axis]`` to a
    float64-class backward error (``b: [N]``): one distributed LU, then
    ``iters`` rounds of refinement with row-local float64 residuals."""
    n, d_axis, nb, d, group = _setup(a, mesh, axis, nb)
    a = a.to(_F32)
    b = b.to(_F32)
    res = distributed_lu(a, mesh, axis=axis, nb=nb)

    def corr(r):
        return _solve_local(res.lu_sharded, res.perm, r[:, None], n, nb,
                            d_axis, d, group)[:, 0]

    a_rows = shard(a, mesh, axis).to(_F64)
    b_rows = shard(b, mesh, axis).to(_F64)
    x = corr(b).to(_F64)
    resid = torch.full((), torch.inf, dtype=_F32, device=a.device)
    for _ in range(iters):
        r_loc = b_rows - a_rows @ x
        r = comm.all_gather(r_loc.to(_F32), group, tiled=True)
        x = x + corr(r).to(_F64)
        resid = r.abs().amax()
    x_hi = x.to(_F32)
    x_lo = (x - x_hi.to(_F64)).to(_F32)
    scale = torch.maximum(
        a.abs().amax() * x_hi.abs().amax(),
        torch.clamp(b.abs().amax(), min=1e-30),
    )
    ok = res.ok & (resid <= 1e-10 * scale)
    return DistributedDDSolve(x_hi, x_lo, resid, ok)
