"""Block-sparse operators: a batched block matvec and the iterative
solves and eigensolves on it (counterpart of
``linalg_solver_tpu.ops.blocksparse``).

An ``n × n`` operator, ``n = nb · bs``, stored as coordinate blocks:
``blocks [nnzb, bs, bs]`` with block-row and block-column indices.  The
reference's matvec is three one-hot GEMMs (a TPU gathers faster that
way).  Here it is a gather of the block columns of v, one batched
product of every stored block, and a deterministic segment sum into the
block rows: when the operator is built, its blocks are sorted by row into
a ``[nb, L]`` table of block indices (L the most blocks a row holds,
shorter rows padded with a zero block), and the sum runs over the table's
second axis in that fixed order.  ``index_add_`` would also do, but its
atomics reorder the sums from run to run on CUDA.  The matvec follows the
batched-vector convention of ``ops.krylov`` and ``ops.arnoldi``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.precision import f32_matmuls
from .krylov import KrylovResult, bicgstab_matvec, cg_matvec, gmres_matvec


class BlockSparse(NamedTuple):
    """One block-sparse operator; ``(rows[k], cols[k])`` locates
    ``blocks[k]``, in any order; duplicate coordinates sum."""

    blocks: torch.Tensor  # [nnzb, bs, bs]
    rows: torch.Tensor    # [nnzb] int64 block-row index
    cols: torch.Tensor    # [nnzb] int64 block-column index
    nb: int               # blocks a side

    @property
    def bs(self) -> int:
        return self.blocks.shape[-1]

    @property
    def n(self) -> int:
        return self.nb * self.bs


def blocksparse_from_dense(a, bs: int, tol: float = 0.0,
                           device: Optional[torch.device | str] = None
                           ) -> BlockSparse:
    """The ``bs × bs`` tiles of a dense ``[n, n]`` matrix whose largest
    magnitude exceeds ``tol`` (a host constructor: the block pattern is
    fixed from here on).  On ``device``, by default the input tensor's
    (the CPU for an array)."""
    if device is None:
        device = a.device if isinstance(a, torch.Tensor) else "cpu"
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    n = a.shape[0]
    if n % bs:
        raise ValueError(f"n={n} not divisible by block size {bs}")
    nb = n // bs
    tiles = a.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    rows, cols = np.nonzero(np.abs(tiles).max(axis=(2, 3)) > tol)
    return BlockSparse(
        torch.from_numpy(np.ascontiguousarray(
            tiles[rows, cols].astype(np.float32))).to(device),
        torch.from_numpy(rows.astype(np.int64)).to(device),
        torch.from_numpy(cols.astype(np.int64)).to(device), nb)


def _row_table(op: BlockSparse) -> torch.Tensor:
    """``[nb, L]`` block indices, row r's blocks in storage order, padded
    with ``nnzb`` (the zero block appended by the matvec)."""
    nnzb = op.rows.shape[0]
    rows = op.rows.cpu().numpy()
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=op.nb)
    table = np.full((op.nb, max(int(counts.max(initial=0)), 1)), nnzb,
                    np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for r in range(op.nb):
        table[r, :counts[r]] = order[start[r]:start[r] + counts[r]]
    return torch.from_numpy(table).to(op.blocks.device)


def blocksparse_to_dense(op: BlockSparse) -> torch.Tensor:
    """Materialize ``[n, n]`` (tests and small fallbacks), summing
    duplicates in the row table's order."""
    nb, bs = op.nb, op.bs
    blocks = torch.cat([op.blocks, op.blocks.new_zeros(1, bs, bs)])
    cols = torch.cat([op.cols, op.cols.new_zeros(1)])
    table = _row_table(op)
    onehot = (cols[table][:, :, None] == torch.arange(
        nb, device=cols.device)).to(blocks.dtype)        # [nb, L, nb]
    tiles = (onehot[:, :, :, None, None] * blocks[table][:, :, None]
             ).sum(dim=1)                                 # [nb, nb, bs, bs]
    return tiles.transpose(1, 2).reshape(nb * bs, nb * bs)


def make_blocksparse_matvec(op: BlockSparse):
    """Batched matvec closure ``v [B, n] → A v [B, n]`` for the matrix-free
    Krylov and Arnoldi entry points."""
    nb, bs = op.nb, op.bs
    blocks = torch.cat([op.blocks, op.blocks.new_zeros(1, bs, bs)])
    cols = torch.cat([op.cols, op.cols.new_zeros(1)])
    table = _row_table(op)

    def matvec(v):
        vc = v.reshape(v.shape[0], nb, bs)[:, cols]       # [B, nnzb+1, bs]
        with f32_matmuls():
            yk = (blocks @ vc[..., None])[..., 0]         # [B, nnzb+1, bs]
        return yk[:, table].sum(dim=2).reshape(v.shape[0], nb * bs
                                               ).to(v.dtype)

    return matvec


def _jacobi_from_blocks(op: BlockSparse):
    """``1/diag`` from the diagonal blocks (at least eps in magnitude)."""
    bs = op.bs
    bdiag = torch.diagonal(op.blocks, dim1=1, dim2=2) * (
        op.rows == op.cols).to(op.blocks.dtype)[:, None]
    bdiag = torch.cat([bdiag, bdiag.new_zeros(1, bs)])
    d = bdiag[_row_table(op)].sum(dim=1).reshape(op.nb * bs)
    dinv = 1.0 / torch.clamp(d.abs(), min=torch.finfo(op.blocks.dtype).eps)
    return lambda v: dinv[None, :] * v


def blocksparse_solve(op: BlockSparse, b: torch.Tensor,
                      method: str = "gmres", tol=None, precond: bool = True,
                      **kw) -> KrylovResult:
    """Iterative solve ``A x = b`` (``b [B, n]``) on a block-sparse
    operator: ``method`` ∈ cg (SPD) / bicgstab / gmres, Jacobi
    preconditioning from the diagonal blocks."""
    mv = make_blocksparse_matvec(op)
    M = _jacobi_from_blocks(op) if precond else None
    solvers = {"cg": cg_matvec, "bicgstab": bicgstab_matvec,
               "gmres": gmres_matvec}
    if method not in solvers:
        raise ValueError(f"method={method!r} not in cg/bicgstab/gmres")
    return solvers[method](mv, b, tol=tol, precond=M, **kw)


def blocksparse_eigs(op: BlockSparse, k: int, batch: int = 1,
                     which: str = "LM", v0: Optional[torch.Tensor] = None,
                     **kw):
    """``k`` exterior eigenpairs of the operator by matrix-free
    Krylov–Schur (``ops.arnoldi``): ``batch`` independent runs, started
    from ``v0 [batch, n]`` (by default a seeded draw)."""
    from .arnoldi import _default_v0, eigs_arnoldi_matvec

    if v0 is None:
        v0 = _default_v0(batch, op.n, op.blocks.dtype, op.blocks.device)
    return eigs_arnoldi_matvec(make_blocksparse_matvec(op), v0, k,
                               which=which, **kw)
