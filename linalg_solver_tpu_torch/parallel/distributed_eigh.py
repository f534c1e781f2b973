"""Distributed symmetric eigendecomposition and SVD of ONE mesh-sharded
matrix, by block Jacobi over a ring of ranks (counterpart of
``linalg_solver_tpu.parallel.distributed_eigh``).

Algorithm (block Jacobi, Brent–Luk round-robin): the columns are split
into 2p blocks of width w = n/(2p); rank d starts with blocks
(2d, 2d+1).  Each round, every rank

1. takes its ``2w × 2w`` pivot subproblem ``A[{I,J},{I,J}]`` from the
   rows of its own columns (local: the columns are the shard),
2. solves it with one small ``eigh`` (``ops.symmetric.eigh_batched``),
   the block rotation, reordered and sign-fixed to lie closest to I,
3. applies the rotation to its columns (one ``[n, 2w] × [2w, 2w]``
   product),
4. all-gathers the p rotations and applies each pair's transpose to the
   matching local rows (the left side of the similarity, local because
   rows are whole),
5. moves block contents one step around the ring (three ppermutes of
   ``[n, w]`` blocks, ``_rotate_ring``: the only O(n·w) communication).

2p − 1 rounds visit every block pair (a sweep) and bring the contents
home.  The sweep loop is adaptive: the reference's device
``while_loop`` stops on a device flag; here the two convergence scalars
are read on the host once a sweep, and ``sweeps_used`` is the count run.
The input is the global matrix (the same on every rank); ``V`` (and the
SVD's ``U``, ``V``) come back as this rank's ``2w`` columns, ``w`` / ``s``
replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.symmetric import eigh_batched
from ..utils.precision import f32_matmuls
from . import comm
from .mesh import axis_index, axis_size, shard


class DistributedEigh(NamedTuple):
    w: torch.Tensor          # [n] eigenvalues, paired with V's columns
    #                          (block-Jacobi order, NOT sorted)
    V: torch.Tensor          # [n, n/p] this rank's eigenvector columns
    converged: torch.Tensor  # [] bool: off-diagonal mass ≤ tol·‖A‖_F
    offnorm: torch.Tensor    # [] final ‖offdiag‖_F / ‖A‖_F
    sweeps_used: torch.Tensor  # [] int32: sweeps run


def _rotate_ring(x, group, p: int, d: int):
    """One Brent–Luk circle-method step on the (top, bottom) content ring:
    top[0] fixed; bottom[0]→top[1]; top[d]→top[d+1]; bottom[d]→bottom[d−1];
    top[p−1]→bottom[p−1].  Three ppermutes, as the reference's."""
    top, bottom = x
    t_shift = comm.ppermute(top, group, [(e, e + 1) for e in range(p - 1)])
    b_shift = comm.ppermute(bottom, group, [(e, e - 1) for e in range(1, p)])
    b0_to_t1 = comm.ppermute(bottom, group, [(0, 1)])
    new_top = top if d == 0 else (b0_to_t1 if d == 1 else t_shift)
    new_bottom = top if d == p - 1 else b_shift
    return new_top, new_bottom


def _closest_to_identity(V: torch.Tensor) -> torch.Tensor:
    """Column reorder (greedy row-wise matching) and sign fix so that the
    orthogonal ``V`` lies as close to I as its column set allows: ``eigh``
    orders by eigenvalue, which makes the block rotation a near
    permutation once blocks are roughly sorted, and a permutation moves
    off-diagonal mass between blocks without reducing it.  Row i takes
    the first largest ``|V[i, j]|`` among the columns not taken yet."""
    from ..ops.kernels.gauss_jordan import _first_argmax

    m = V.shape[0]
    absV = V.abs()
    used = torch.zeros(m, dtype=torch.bool, device=V.device)
    perm = torch.zeros(m, dtype=torch.int64, device=V.device)
    for i in range(m):
        j = _first_argmax(torch.where(used, -1.0, absV[i])[None])[0]
        used[j] = True
        perm[i] = j
    W = V.index_select(1, perm)
    s = torch.sign(torch.diagonal(W))
    return W * torch.where(s == 0, 1.0, s)[None, :]


def _rows(C, start, w):
    """Rows ``start … start + w`` of ``C``, ``start`` a 0-d device tensor."""
    return C.index_select(0, start * w + torch.arange(w, device=C.device))


def _place(n, start, w, vals):
    """An ``[n]`` zero vector with ``vals`` at ``start … start + w``."""
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    out[start:start + w] = vals
    return out


def _block_rotation(S):
    """The closest-to-identity eigenvector basis of a symmetric block."""
    return _closest_to_identity(eigh_batched((0.5 * (S + S.T))[None]).V[0])


def _eigh_jacobi_local(a_loc, group, p: int, d: int, w: int, sweeps: int,
                       tol: float):
    n = a_loc.shape[0]
    dtype, dev = a_loc.dtype, a_loc.device
    C_top, C_bot = a_loc[:, :w], a_loc[:, w:]
    eyew = torch.eye(w, dtype=dtype, device=dev)
    W_top = torch.zeros(n, w, dtype=dtype, device=dev)
    W_bot = torch.zeros(n, w, dtype=dtype, device=dev)
    W_top[2 * d * w:(2 * d + 1) * w] = eyew
    W_bot[(2 * d + 1) * w:(2 * d + 2) * w] = eyew
    tid = torch.tensor([2 * d], dtype=torch.int32, device=dev)
    bid = torch.tensor([2 * d + 1], dtype=torch.int32, device=dev)
    rounds = max(2 * p - 1, 1)

    def round_body(st):
        C_top, C_bot, W_top, W_bot, tid, bid = st
        C = torch.cat([C_top, C_bot], dim=1)                 # [n, 2w]
        Wl = torch.cat([W_top, W_bot], dim=1)
        ti, bi = tid[0].long(), bid[0].long()
        S = torch.cat([_rows(C, ti, w), _rows(C, bi, w)])    # [2w, 2w]
        V = _block_rotation(S)
        # the right side of the similarity, and the eigenvector update
        C = C @ V
        Wl = Wl @ V
        # the left side: every pair's Vᵀ on the matching local rows
        Vs = comm.all_gather(V, group)                       # [p, 2w, 2w]
        tis = comm.all_gather(tid, group)[:, 0].long()       # [p]
        bis = comm.all_gather(bid, group)[:, 0].long()
        ar = torch.arange(w, device=dev)
        for e in range(p):
            ri, rj = tis[e] * w + ar, bis[e] * w + ar
            blk = Vs[e].T @ torch.cat([C.index_select(0, ri),
                                       C.index_select(0, rj)])
            C = C.index_copy(0, ri, blk[:w]).index_copy(0, rj, blk[w:])
        C_top, C_bot = C[:, :w], C[:, w:]
        W_top, W_bot = Wl[:, :w], Wl[:, w:]
        if p > 1:
            C_top, C_bot = _rotate_ring((C_top, C_bot), group, p, d)
            W_top, W_bot = _rotate_ring((W_top, W_bot), group, p, d)
            tid, bid = _rotate_ring((tid, bid), group, p, d)
        return C_top, C_bot, W_top, W_bot, tid, bid

    def off_mass(C_top, C_bot):
        """Off-diagonal mass of the local columns (everything outside the
        two diagonal w×w blocks) and the total Frobenius mass, each summed
        directly (a ``total − ondiag`` difference cancels in f32)."""
        C = torch.cat([C_top, C_bot], dim=1)
        Co = C.clone()
        Co[2 * d * w:(2 * d + 1) * w, :w] = 0
        Co[(2 * d + 1) * w:(2 * d + 2) * w, w:] = 0
        off = comm.psum((Co * Co).sum(), group)
        fro = comm.psum((C * C).sum(), group)
        return off, fro

    st = (C_top, C_bot, W_top, W_bot, tid, bid)
    off, fro = off_mass(C_top, C_bot)
    k = 0
    # whole sweeps only (the ring's period is 2p − 1, so contents are home
    # at sweep boundaries); squared test: off ≤ tol²·fro ⟺ ‖off‖/‖A‖ ≤ tol
    while k < sweeps and bool(off > (tol * tol) * fro):
        for _ in range(rounds):
            st = round_body(st)
        off, fro = off_mass(st[0], st[1])
        k += 1
    C_top, C_bot, W_top, W_bot, _, _ = st
    # eigenvalues: the diagonal of the block-diagonalized matrix at the
    # global positions of the local blocks; one all-reduce replicates them
    dt = torch.diagonal(C_top[2 * d * w:(2 * d + 1) * w])
    db = torch.diagonal(C_bot[(2 * d + 1) * w:(2 * d + 2) * w])
    wvec = comm.psum(_place(n, 2 * d * w, w, dt)
                     + _place(n, (2 * d + 1) * w, w, db), group)
    return wvec, torch.cat([W_top, W_bot], dim=1), off, fro, k


class DistributedSVDJacobi(NamedTuple):
    U: torch.Tensor          # [m, n/p] this rank's left singular vectors
    #                          (zero columns where s == 0)
    s: torch.Tensor          # [n] singular values (Jacobi order, NOT
    #                          sorted), replicated
    V: torch.Tensor          # [n, n/p] this rank's right singular vectors
    converged: torch.Tensor  # [] bool
    offnorm: torch.Tensor    # [] final Gram off-diagonality
    sweeps_used: torch.Tensor  # [] int32: sweeps run


def _svd_jacobi_local(a_loc, group, p: int, d: int, w: int, sweeps: int,
                      tol: float):
    """One-sided block Jacobi: column blocks orthogonalized pairwise.  The
    2w×2w Gram and the rotation are local (rows whole), so the ring
    rotation is the only collective besides one scalar pmax a sweep."""
    dtype, dev = a_loc.dtype, a_loc.device
    n = 2 * p * w
    C_top, C_bot = a_loc[:, :w], a_loc[:, w:]
    eyew = torch.eye(w, dtype=dtype, device=dev)
    W_top = torch.zeros(n, w, dtype=dtype, device=dev)
    W_bot = torch.zeros(n, w, dtype=dtype, device=dev)
    W_top[2 * d * w:(2 * d + 1) * w] = eyew
    W_bot[(2 * d + 1) * w:(2 * d + 2) * w] = eyew
    rounds = max(2 * p - 1, 1)

    def round_body(st):
        C_top, C_bot, W_top, W_bot = st
        C = torch.cat([C_top, C_bot], dim=1)                 # [m, 2w]
        Wl = torch.cat([W_top, W_bot], dim=1)
        V = _block_rotation(C.T @ C)
        C = C @ V
        Wl = Wl @ V
        C_top, C_bot = C[:, :w], C[:, w:]
        W_top, W_bot = Wl[:, :w], Wl[:, w:]
        if p > 1:
            C_top, C_bot = _rotate_ring((C_top, C_bot), group, p, d)
            W_top, W_bot = _rotate_ring((W_top, W_bot), group, p, d)
        return C_top, C_bot, W_top, W_bot

    def gram_offmax(C_top, C_bot):
        """Gram off-diagonality of the local pair, maxed over the ranks
        (one scalar pmax)."""
        C = torch.cat([C_top, C_bot], dim=1)
        G = C.T @ C
        dG = torch.diagonal(G)
        scale = torch.sqrt(torch.clamp(dG[:, None] * dG[None, :],
                                       min=torch.finfo(dtype).tiny))
        return comm.pmax(((G - torch.diag(dG)).abs() / scale).amax(), group)

    st = (C_top, C_bot, W_top, W_bot)
    offmax = gram_offmax(C_top, C_bot)
    k = 0
    while k < sweeps and bool(offmax > tol):
        for _ in range(rounds):
            st = round_body(st)
        offmax = gram_offmax(st[0], st[1])
        k += 1
    C = torch.cat([st[0], st[1]], dim=1)
    Wl = torch.cat([st[2], st[3]], dim=1)
    # singular values = column norms; U = normalized columns
    s_loc = torch.sqrt((C * C).sum(dim=0))                   # [2w]
    U_loc = C / torch.clamp(s_loc, min=torch.finfo(dtype).tiny)[None, :]
    U_loc = torch.where(s_loc[None, :] > 0, U_loc, 0.0)
    svec = comm.psum(_place(n, 2 * d * w, w, s_loc[:w])
                     + _place(n, (2 * d + 1) * w, w, s_loc[w:]), group)
    return U_loc, svec, Wl, offmax, k


def _check(n: int, p: int, what: str) -> int:
    if n % (2 * p) != 0:
        raise ValueError(
            f"{what} needs n divisible by 2·p; got n={n}, p={p}")
    return n // (2 * p)


@f32_matmuls()
def distributed_svd_jacobi(
    a: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    sweeps: int = 10,
    tol: float = 1e-4,
) -> DistributedSVDJacobi:
    """SVD ``A = U diag(s) Vᵀ`` of one ``[m, n]`` matrix column-sharded
    over ``mesh[axis]`` by one-sided block Jacobi.  Requires
    ``n % (2p) == 0``.  Singular values come back unsorted but paired with
    U's and V's columns; the sweep loop stops at the first sweep whose
    pairwise Gram criterion meets ``tol`` (``sweeps`` is the cap)."""
    p = axis_size(mesh, axis)
    w = _check(a.shape[1], p, "distributed_svd_jacobi")
    U, s, V, off, k = _svd_jacobi_local(
        shard(a, mesh, axis, dim=1), mesh.get_group(axis), p,
        axis_index(mesh, axis), w, sweeps, tol)
    return DistributedSVDJacobi(
        U, s, V, off <= tol, off,
        torch.tensor(k, dtype=torch.int32, device=a.device))


@f32_matmuls()
def distributed_eigh(
    a: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    sweeps: int = 8,
    tol: float = 1e-5,
) -> DistributedEigh:
    """Eigendecomposition ``A = V diag(w) Vᵀ`` of one symmetric ``[n, n]``
    matrix column-sharded over ``mesh[axis]``.  Requires ``n % (2p) ==
    0`` for ``p`` the axis size.  Eigenvalues come back unsorted
    (block-Jacobi order) but paired with V's columns.  The sweep loop
    stops as soon as ``‖offdiag‖_F ≤ tol·‖A‖_F`` (``sweeps`` is the cap;
    comm model: ``comm.model_eigh_adaptive(n, p, w, sweeps_used)``)."""
    p = axis_size(mesh, axis)
    w = _check(a.shape[0], p, "distributed_eigh")
    wvec, V, off, fro, k = _eigh_jacobi_local(
        shard(a, mesh, axis, dim=1), mesh.get_group(axis), p,
        axis_index(mesh, axis), w, sweeps, tol)
    offnorm = torch.sqrt(off / torch.clamp(fro, min=torch.finfo(a.dtype).tiny))
    return DistributedEigh(
        wvec, V, offnorm <= tol, offnorm,
        torch.tensor(k, dtype=torch.int32, device=a.device))
