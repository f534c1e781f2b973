"""Distributed factorizations of ONE tall matrix, row-sharded over a mesh
axis (counterpart of ``linalg_solver_tpu.parallel.distributed_tall``).

``distributed_lu`` scales a single square system by column blocks; this
module scales the tall case, ``[M, n]`` with M large and n small enough
that an ``[n, n]`` Gram matrix is replicated cheaply.  Every algorithm
has the same communication signature: ONE all-reduce of an ``[n, n]``
(or ``[n, k]``) local product per pass, all O(M) work local to the
rank's rows:

- ``distributed_cholqr2``: shifted CholeskyQR2, Q row-sharded, R
  replicated;
- ``distributed_lstsq``: least squares through that QR and refinement
  (the residual product local, one all-reduce a step);
- ``distributed_polar_tall`` / ``distributed_svd_tall``: QDWH polar
  iterations (local triangular solves against the replicated Cholesky
  factor of ``I + c·Gram``) and the SVD from the polar factor and a
  replicated ``eigh``; U stays row-sharded;
- ``distributed_randomized_svd``: the randomized SVD with its probes
  local and every orthonormalization one all-reduce.

Each function takes the global matrix (the same on every rank) and
returns the row-sharded factors as this rank's contiguous block of rows
(the reference's shard order) and the small ones replicated.  Every
collective goes through ``comm`` (the reference calls ``lax`` directly
here, so its meter sees none of them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.spd import cholesky_or_nan
from ..ops.svd import _qdwh_coeffs
from ..ops.symmetric import eigh_batched
from ..utils.precision import f32_matmuls
from . import comm
from .mesh import shard


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.promote_types(a.dtype, torch.float32))


def _psum_gram(x_loc, y_loc, group):
    """All-reduce of the local ``[n, k]`` product ``xᵀy``, the ONE
    collective of a pass."""
    return comm.psum(x_loc.T @ y_loc, group)


def _lower_solve_rows(L, x):
    """``(L⁻¹ xᵀ)ᵀ`` for a lower-triangular ``L`` and rows ``x [M, n]``."""
    return torch.linalg.solve_triangular(L, x.T, upper=False).T


def _cholqr2_local(a_loc, group):
    """Shifted CholeskyQR2 of the row-sharded tall matrix: ``(q_loc, R)``
    with R replicated."""
    n = a_loc.shape[1]
    dtype = a_loc.dtype
    eps = torch.finfo(dtype).eps
    eye = torch.eye(n, dtype=dtype, device=a_loc.device)
    # column pre-scaling by the global column norms (one all-reduce)
    sq = comm.psum((a_loc * a_loc).sum(dim=0), group)
    d = torch.clamp(torch.sqrt(sq), min=1e-30)
    g = a_loc / d[None, :]
    gram = _psum_gram(g, g, group)
    shift = 16.0 * n * eps
    L1 = cholesky_or_nan((gram + shift * torch.trace(gram) * eye)[None])[0]
    q = _lower_solve_rows(L1, g)
    L2 = cholesky_or_nan(_psum_gram(q, q, group)[None])[0]
    q = _lower_solve_rows(L2, q)
    R = (L1 @ L2).T * d[None, :]
    return q, R


class DistributedQR(NamedTuple):
    q: torch.Tensor   # [M/D, n] this rank's rows of the orthonormal Q
    R: torch.Tensor   # [n, n] replicated upper-triangular
    ok: torch.Tensor  # [] all factors finite


@f32_matmuls()
def distributed_cholqr2(a: torch.Tensor, mesh: DeviceMesh,
                        axis: str = "dp") -> DistributedQR:
    """QR of one tall ``[M, n]`` matrix row-sharded over ``mesh[axis]``:
    ``a = q @ R``."""
    q, R = _cholqr2_local(shard(_f32(a), mesh, axis), mesh.get_group(axis))
    return DistributedQR(q, R, torch.isfinite(R).all())


@f32_matmuls()
def distributed_lstsq(a: torch.Tensor, b: torch.Tensor, mesh: DeviceMesh,
                      axis: str = "dp", ir_steps: int = 1) -> torch.Tensor:
    """Least-squares solution of one row-sharded tall system,
    ``x = argmin ‖a x − b‖₂`` with ``a [M, n]``, ``b [M]`` or ``[M, k]``;
    x replicated.  One all-reduce a substitution or refinement pass; the
    residual product is local to each rank."""
    group = mesh.get_group(axis)
    vector_input = b.ndim == 1
    b2 = b[:, None] if vector_input else b
    a_loc = shard(_f32(a), mesh, axis)
    b_loc = shard(b2.to(a_loc.dtype), mesh, axis)
    q, R = _cholqr2_local(a_loc, group)

    def solve_ls(rhs_loc):
        y = _psum_gram(q, rhs_loc, group)
        return torch.linalg.solve_triangular(R, y, upper=True)

    x = solve_ls(b_loc)
    for _ in range(ir_steps):
        x = x + solve_ls(b_loc - a_loc @ x)
    return x[:, 0] if vector_input else x


class DistributedPolar(NamedTuple):
    up: torch.Tensor  # [M/D, n] this rank's rows of the polar factor
    H: torch.Tensor   # [n, n] replicated symmetric PSD factor (a = up H)
    ok: torch.Tensor


class DistributedSVD(NamedTuple):
    U: torch.Tensor   # [M/D, n] this rank's rows
    s: torch.Tensor   # [n] replicated, descending
    V: torch.Tensor   # [n, n] replicated
    ok: torch.Tensor


def _polar_local(a_loc, group, iters: int, l0: float):
    dtype = a_loc.dtype
    n = a_loc.shape[1]
    eye = torch.eye(n, dtype=dtype, device=a_loc.device)
    # σmax ≤ √(‖A‖₁·‖A‖∞): column sums need a psum, row sums a pmax
    n1 = comm.psum(a_loc.abs().sum(dim=0), group).amax()
    ninf = comm.pmax(a_loc.abs().sum(dim=1).amax(), group)
    alpha = torch.clamp(torch.sqrt(n1 * ninf), min=1e-30)
    x = a_loc / alpha
    l = torch.tensor(l0, dtype=dtype, device=a_loc.device)
    for _ in range(iters):
        a_k, b_k, c_k, l = _qdwh_coeffs(l)
        W = cholesky_or_nan((eye + c_k * _psum_gram(x, x, group))[None])[0]
        y = torch.linalg.solve_triangular(W, x.T, upper=False)
        y = torch.linalg.solve_triangular(W.T, y, upper=True).T
        x = (b_k / c_k) * x + (a_k - b_k / c_k) * y
    H = _psum_gram(x, a_loc, group)
    H = 0.5 * (H + H.T)
    return x, H, torch.isfinite(H).all()


@f32_matmuls()
def distributed_polar_tall(a: torch.Tensor, mesh: DeviceMesh,
                           axis: str = "dp", iters: int = 8
                           ) -> DistributedPolar:
    """Polar decomposition ``a = up @ H`` of one row-sharded tall matrix by
    QDWH: per iteration one ``[n, n]`` all-reduce, a replicated Cholesky
    and local triangular solves over the rank's rows."""
    return DistributedPolar(*_polar_local(
        shard(_f32(a), mesh, axis), mesh.get_group(axis), iters, 1e-3))


@f32_matmuls()
def distributed_svd_tall(a: torch.Tensor, mesh: DeviceMesh,
                         axis: str = "dp", iters: int = 8) -> DistributedSVD:
    """Thin SVD of one row-sharded tall ``[M, n]`` matrix: the QDWH polar
    factor stays sharded, the ``[n, n]`` eigensolve is replicated
    (``ops.symmetric.eigh_batched``), and ``U = up V`` is a local product
    on each rank."""
    pol = distributed_polar_tall(a, mesh, axis=axis, iters=iters)
    eig = eigh_batched(pol.H[None])
    s = torch.clamp(eig.w[0].flip(0), min=0.0)
    V = eig.V[0].flip(1)
    return DistributedSVD(pol.up @ V, s, V, pol.ok)


class DistributedRSVD(NamedTuple):
    U: torch.Tensor      # [M/D, k] this rank's rows
    s: torch.Tensor      # [k] replicated, descending
    V: torch.Tensor      # [n, k] replicated
    valid: torch.Tensor  # [k] replicated: False beyond numerical rank
    ok: torch.Tensor


def _orth_rank_revealing_dist(Y_loc, group):
    """Rank-revealing orthonormalization of a row-sharded sample block
    (the distributed twin of ``ops.randomized._orth_rank_revealing``):
    eigh of the all-reduced Gram, dropped directions zeroed, one patched
    Cholesky refinement; all O(M) work local."""
    ell = Y_loc.shape[1]
    dtype = Y_loc.dtype
    eps = torch.finfo(dtype).eps
    eye = torch.eye(ell, dtype=dtype, device=Y_loc.device)
    eig = eigh_batched(_psum_gram(Y_loc, Y_loc, group)[None])
    w, P = eig.w[0], eig.V[0]
    wmax = torch.clamp(w[-1:], min=torch.finfo(dtype).tiny)
    valid = w > (4.0 * eps) * wmax
    scale = torch.where(valid, 1.0 / torch.sqrt(torch.clamp(w, min=1e-30)),
                        0.0)
    Q = Y_loc @ (P * scale[None, :])
    validf = valid.to(dtype)
    g2 = _psum_gram(Q, Q, group)
    g2 = (g2 * validf[:, None] * validf[None, :]
          + (1.0 - validf)[None, :] * eye)
    L = cholesky_or_nan(g2[None])[0]
    Q = _lower_solve_rows(L, Q) * validf[None, :]
    return Q, torch.isfinite(Q).all()


@f32_matmuls()
def distributed_randomized_svd(
    a: torch.Tensor, mesh: DeviceMesh, k: int,
    omega: Optional[torch.Tensor] = None, axis: str = "dp",
    oversample: int = 8, power_iters: int = 2,
) -> DistributedRSVD:
    """Rank-k randomized SVD of ONE row-sharded ``[M, n]`` matrix: the
    probe products and the final ``U = Q Ũ`` are local to each rank, every
    orthonormalization and Gram is one ``[ell, ell]`` (or ``[ell, n]``)
    all-reduce, and the small core SVD (``ops.svd.svd_batched``) is
    replicated.  ``omega [n, ell]`` (ell = min(k + oversample, n)) is the
    Gaussian sketch, the same on every rank; by default it is drawn from
    a CPU generator seeded 0 (the reference draws it from
    ``PRNGKey(0)``; tests pass that draw)."""
    from ..ops.randomized import _orth_rank_revealing
    from ..ops.svd import svd_batched

    M, n = a.shape
    ell = min(k + oversample, n)
    if k > n:
        raise ValueError(f"k={k} exceeds n={n}")
    group = mesh.get_group(axis)
    a_loc = shard(_f32(a), mesh, axis)
    if omega is None:
        omega = torch.randn(n, ell, generator=torch.Generator().manual_seed(0))
    omega = omega.to(a_loc.dtype).to(a_loc.device)

    Y = a_loc @ omega
    ok = torch.ones((), dtype=torch.bool, device=a_loc.device)
    for _ in range(power_iters):
        Q, okq = _orth_rank_revealing_dist(Y, group)
        Z = _psum_gram(a_loc, Q, group)             # [n, ell] = AᵀQ
        # Z is replicated: the batched orthonormalization applies as is
        Qz, okz = _orth_rank_revealing(Z[None])
        ok = ok & okq & okz[0]
        Y = a_loc @ Qz[0]
    Q, okq = _orth_rank_revealing_dist(Y, group)
    ok = ok & okq
    Bcore = _psum_gram(Q, a_loc, group)             # [ell, n]
    # every rank's local finiteness must hold
    ok = comm.pmax((~ok).to(torch.int32), group) == 0

    core = svd_batched(Bcore[None])
    s = core.s[0, :k]
    V = core.V[0, :, :k]
    U = Q @ core.U[0, :, :k]
    eps = torch.finfo(a_loc.dtype).eps
    # rank floor relative to s[0], scaled with the sample width ell
    valid = s > (ell * eps) * torch.clamp(s[:1], min=1e-30)
    return DistributedRSVD(U, s, V, valid, ok & core.ok[0])
