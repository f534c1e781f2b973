"""Batched Gauss–Jordan with in-place partial pivoting (counterpart of
``linalg_solver_tpu.ops.pallas.gj_kernel``), and the inverse, solve,
determinant and rank built on it.

``gauss_jordan_tiled`` launches ``csrc/gauss_jordan.cu`` (one thread
block per matrix) on a CUDA tensor, and runs ``gauss_jordan_reference``,
the same steps in plain PyTorch vectorised over the batch, on a CPU
tensor.  On a CUDA tensor it launches the kernel or raises; it never
falls back.  The kernel has four variants, chosen by shape alone
(``variant``): the ``[N, W]`` array in registers at ``N ≤ 64, W ≤ 128``
(256 threads) and at ``N ≤ 128, W ≤ 256`` (1024 threads), else in shared
memory (1024 threads) where a block's shared memory holds it (``fits``,
the reach of the inverse, solve and det routes), else in the shared
memory of a thread-block cluster of ``cluster_size`` blocks of 1024
threads (2, 4 or 8, a block holding every C-th column) within the
reference's big VMEM budget (``fits_big``: ``[N, N]`` to 424,
``[N, N + 1]`` to 423), which only the rank and the affine solve take,
as in the reference.  ``LAUNCHES`` counts kernel launches of every
variant.

Step ``j`` takes as pivot the first row of largest ``|a[:, j]|`` among
the rows not pivoted yet (a NaN counts as the largest, as in
``jnp.argmax``).  If its magnitude exceeds the matrix's ``tol`` the row
is normalised and column ``j`` eliminated from every other row; else the
column is skipped.  Rows are never swapped: ``perm[j]`` is the physical
row that holds pivot ``j``.  The pivot row and value are read the way
the TPU kernel reads them, as a sum of the column times a one-hot mask,
so a non-finite entry anywhere in a column makes them NaN.

Not ported: the padding of W to a multiple of 8, the identity filler
to 128 lanes and the ``[N, W, B]`` transpose, which exist for the TPU's
tiles and lanes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

#: shared memory a thread block may use on sm_90 (bytes)
_MAX_SMEM = 232448

#: the argmax slots of csrc/gj_pivot.cuh's layout (two per warp of 8)
_NWARP = 8

#: the reference's big VMEM budget (``gj_kernel.VMEM_TILE_BUDGET_BIG``,
#: 88 MiB) over its 128 lanes of 4 bytes: elements of an
#: ``[n, ⌈w/8⌉·8]`` tile
_BIG_ELEMS = 88 * 2**20 // (128 * 4)

#: kernel launches since import (or since the caller last reset it)
LAUNCHES = 0


class GJResult(NamedTuple):
    reduced: torch.Tensor  # [B, N, W] fully reduced array, rows in place
    perm: torch.Tensor     # [B, N] int32: physical row holding pivot j
    pivots: torch.Tensor   # [B, N] pivot values in order (0 if skipped)


def smem_bytes(n: int, w: int) -> int:
    """Shared memory the kernel takes for an ``[n, w]`` array, in bytes:
    the mirror of ``gj_smem_floats`` in ``csrc/gj_pivot.cuh`` (the array
    with an odd row stride, the staged pivot row, two per-column counts
    of non-finite entries, and per-row coefficient, pivoted flag, perm,
    pivot and argmax slots)."""
    ld = w | 1
    return 4 * (n * ld + w + 2 * w + 3 * n + n + 2 * _NWARP)


def fits(n: int, w: int) -> bool:
    """Whether a block's shared memory holds the kernel's ``[n, w]``
    array (``w >= n``): the reach of the inverse, solve and det routes."""
    return 1 <= n <= w and smem_bytes(n, w) <= _MAX_SMEM


def fits_big(n: int, w: int) -> bool:
    """Whether ``[n, w]`` is within the reference's big budget, the reach
    of the rank and the affine solve: ``n ≤ w`` and ``n·⌈w/8⌉·8 ≤
    180,224`` (``gj_kernel.supported(n, w, VMEM_TILE_BUDGET_BIG)``)."""
    return 1 <= n <= w and n * ((w + 7) // 8 * 8) <= _BIG_ELEMS


def cluster_smem_bytes(n: int, w: int, c: int) -> int:
    """Shared memory of one block of variant 3's ``c``-block cluster at
    ``[n, w]``, in bytes: the mirror of ``gj_cluster_floats`` (the
    block's ``⌈w/c⌉`` columns at the odd stride ``n | 1``, two coefficient
    buffers ``[2, n]``, the columns' non-finite counts and two ``(p,
    has)`` slots)."""
    cmax = -(-w // c)
    return 4 * (cmax * (n | 1) + 2 * n + cmax + 4)


def cluster_size(n: int, w: int) -> int:
    """Variant 3's blocks a cluster at ``[n, w]``: the least of 2, 4 and 8
    whose block share fits (0: none does); the mirror of
    ``gj_cluster_size``."""
    for c in (2, 4, 8):
        if cluster_smem_bytes(n, w, c) <= _MAX_SMEM:
            return c
    return 0


def variant(n: int, w: int) -> int:
    """The variant that takes an ``[n, w]`` array: the mirror of
    ``gj_variant`` in ``csrc/gauss_jordan.cu`` (1: ``n ≤ 64, w ≤ 128``;
    2: ``n ≤ 128, w ≤ 256``; 0: the rest that ``fits``; 3: the rest that
    ``fits_big`` where a cluster holds it, ``n ≤ 448``; -1: none)."""
    if n <= 64 and w <= 128:
        return 1
    if n <= 128 and w <= 256:
        return 2
    if fits(n, w):
        return 0
    if fits_big(n, w) and n <= 448 and cluster_size(n, w):
        return 3
    return -1


def attributes(n: int, w: int) -> dict:
    """Registers, spill bytes and resident blocks an SM of the variant
    that takes ``[n, w]`` (on a machine with the card); for variant 3 also
    its blocks a cluster and the clusters the card holds at once."""
    from . import _build

    v = variant(n, w)
    out = {"variant": v, **_build.attributes("gj_attributes", v, n, w)}
    if v == 3:
        out["cluster_size"] = cluster_size(n, w)
        out["clusters"] = _build.load().gj_clusters(n, w)
    return out


def _check(a: torch.Tensor, tol: Optional[torch.Tensor]):
    if a.dim() != 3 or a.shape[2] < a.shape[1]:
        raise ValueError(f"a must be [B, N, W >= N]; got {tuple(a.shape)}")
    if a.is_complex():
        raise TypeError("gauss_jordan_tiled takes real matrices")
    B = a.shape[0]
    a32 = a.to(torch.float32)
    if tol is None:
        tol = torch.zeros(B, dtype=torch.float32, device=a.device)
    if tuple(tol.shape) != (B,):
        raise ValueError(f"tol must be [{B}]; got {tuple(tol.shape)}")
    return a32, tol.to(device=a.device, dtype=torch.float32)


def gauss_jordan_tiled(
    a: torch.Tensor, tol: Optional[torch.Tensor] = None
) -> GJResult:
    """Eliminate columns ``0..N-1`` of every ``[N, W]`` matrix of ``a``
    (``W >= N``; columns past N are carried along).  ``tol`` is a
    per-matrix pivot threshold ``[B]`` (default 0: any nonzero pivot).
    Other real dtypes are cast to f32."""
    a32, tol = _check(a, tol)
    if a32.is_cuda:
        return _launch(a32, tol)
    if a32.device.type == "cpu":
        return gauss_jordan_reference(a32, tol)
    raise ValueError(f"gauss_jordan_tiled: no kernel for {a32.device}")


def _launch(a32: torch.Tensor, tol: torch.Tensor) -> GJResult:
    global LAUNCHES
    from . import _build

    B, n, w = a32.shape
    lib = _build.load()
    if lib.gj_variant(n, w) < 0:
        raise ValueError(
            f"[{n}, {w}] is past the kernel's reach: {lib.gj_smem_bytes(n, w)}"
            f" bytes of shared memory per block (it has {_MAX_SMEM}) and "
            f"past the big reach (fits_big)")
    if variant(n, w) == 3 and B and _clusters(lib, n, w) < 1:
        c = cluster_size(n, w)
        raise RuntimeError(
            f"gauss_jordan_tiled: the card holds no cluster of {c} blocks "
            f"of {cluster_smem_bytes(n, w, c)} bytes of shared memory, "
            f"which [{n}, {w}] needs (cudaOccupancyMaxActiveClusters: "
            f"{_clusters(lib, n, w)})")
    a32 = a32.contiguous()
    tol = tol.contiguous()
    dev = a32.device
    reduced = torch.empty_like(a32)
    perm = torch.empty(B, n, dtype=torch.int32, device=dev)
    pivots = torch.empty(B, n, dtype=torch.float32, device=dev)
    if B == 0:
        return GJResult(reduced, perm, pivots)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gauss_jordan_f32(
            a32.data_ptr(), tol.data_ptr(), reduced.data_ptr(),
            perm.data_ptr(), pivots.data_ptr(), B, n, w, stream,
        )
    _build.check(err, "gauss_jordan launch")
    LAUNCHES += 1
    return GJResult(reduced, perm, pivots)


_CLUSTERS: dict = {}


def _clusters(lib, n: int, w: int) -> int:
    """Variant 3's clusters resident at once at ``[n, w]``, asked once a
    shape."""
    if (n, w) not in _CLUSTERS:
        _CLUSTERS[n, w] = lib.gj_clusters(n, w)
    return _CLUSTERS[n, w]


def _first_argmax(masked: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` over axis 1 of ``[B, n]``: the first index of the
    maximum, where a NaN counts as the maximum (the first NaN wins)."""
    n = masked.shape[1]
    rows = torch.arange(n, device=masked.device)
    nan = masked.isnan()
    top = torch.where(nan, -torch.inf, masked).amax(dim=1, keepdim=True)
    cand = torch.where(nan.any(dim=1, keepdim=True), nan, masked == top)
    return torch.where(cand, rows, n).amin(dim=1)


def fms(x: torch.Tensor, c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``x − c·p`` of f32 tensors as one fused multiply-add, rounded once
    (the kernels' ``fmaf``; XLA on the CPU fuses the JAX kernels'
    ``x - c * p`` the same way).  The product of two f32 is exact in
    float64.  Rounding the float64 difference to f32 would round twice,
    which errs by one unit in the last place where the first rounding
    lands on an f32 halfway point; so the difference is rounded to odd
    in float64 (its exact error from TwoSum decides the last bit), and
    rounding that to f32 is the correctly rounded result (Boldo and
    Melquiond, 2008: 53 ≥ 24 + 2 bits)."""
    xd = x.double()
    q = -(c.double() * p.double())
    s = xd + q
    bq = s - xd
    err = (xd - (s - bq)) + (q - bq)
    even = (s.view(torch.int64) & 1) == 0
    fix = even & (err != 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, toward), s).to(torch.float32)


def gauss_jordan_reference(
    a: torch.Tensor, tol: Optional[torch.Tensor] = None
) -> GJResult:
    """Plain-PyTorch version of the kernel, vectorised over the batch:
    the same contract as ``gauss_jordan_tiled`` on any device.  One step
    is the TPU kernel's, written for a batch: the pivot row and value are
    one-hot sums, the coefficient is ``where(row == p, 1 − 1/piv,
    col/piv) · act`` and the update ``row − coeff · pivot_row`` (one
    rounding, ``fms``)."""
    arr, tol = _check(a, tol)
    B, n, w = arr.shape
    dev, dt = arr.device, arr.dtype
    rows = torch.arange(n, device=dev)
    pivoted = torch.zeros(B, n, dtype=torch.bool, device=dev)
    perm = torch.zeros(B, n, dtype=torch.int32, device=dev)
    pivs = torch.zeros(B, n, dtype=dt, device=dev)
    for j in range(n):
        col = arr[:, :, j]
        masked = torch.where(pivoted, -torch.inf, col.abs())
        p = _first_argmax(masked)
        is_p = rows[None, :] == p[:, None]
        oh = is_p.to(dt)
        pivot_val = (col * oh).sum(dim=1)
        has = pivot_val.abs() > tol
        inv_piv = 1.0 / torch.where(has, pivot_val, 1.0)
        pivot_row = (arr * oh[:, :, None]).sum(dim=1)
        coeff = torch.where(
            is_p, 1.0 - inv_piv[:, None], col * inv_piv[:, None]
        ) * has.to(dt)[:, None]
        arr = fms(arr, coeff[:, :, None], pivot_row[:, None, :])
        pivoted = pivoted | (is_p & has[:, None])
        perm[:, j] = p.to(torch.int32)
        pivs[:, j] = torch.where(has, pivot_val, 0.0)
    return GJResult(arr, perm, pivs)


def _perm_parity(perm: torch.Tensor) -> torch.Tensor:
    """Sign of the pivot-order permutation, ±1 f32, by counting
    inversions."""
    n = perm.shape[-1]
    pi = perm.to(torch.int64)
    idx = torch.arange(n, device=perm.device)
    k_lt_l = idx[:, None] < idx[None, :]
    inversions = ((pi[..., :, None] > pi[..., None, :]) & k_lt_l).sum(
        dim=(-2, -1))
    return torch.where(inversions % 2 == 0, 1.0, -1.0)


def take_rows(src: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``src[b, perm[b, j], :]`` for ``src [B, n, k]``."""
    return torch.take_along_dim(src, perm.long()[:, :, None], dim=1)


def _like(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The f32 result ``x`` in the dtype of a floating input ``a``, as
    ``inv_rbt.inverse_rbt_fused_batched`` returns it."""
    return x.to(a.dtype) if a.is_floating_point() else x


def _inverse(a: torch.Tensor, eliminate) -> torch.Tensor:
    """Pivoted inverse through ``eliminate`` (the kernel or its plain
    version) on ``[A | I]``: row j of ``A⁻¹`` is physical row ``perm[j]``
    of the right half."""
    B, n, _ = a.shape
    eye = torch.eye(n, dtype=torch.float32, device=a.device).expand(B, n, n)
    res = eliminate(torch.cat([a.to(torch.float32), eye], dim=2))
    return take_rows(res.reduced[:, :, n:], res.perm)


def inverse_batched(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse by the pivoted kernel on ``[A | I]``."""
    return _like(_inverse(a, gauss_jordan_tiled), a)


def inverse_reference(a: torch.Tensor) -> torch.Tensor:
    """Plain version of ``inverse_batched`` (f32), on any device."""
    return _inverse(a, gauss_jordan_reference)


def solve_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched unique-solution solve by the pivoted kernel on
    ``[A | b]``; ``b`` is ``[B, N]`` or ``[B, N, k]``."""
    n = a.shape[-1]
    vector_input = b.dim() == 2
    rhs = b[:, :, None] if vector_input else b
    res = gauss_jordan_tiled(
        torch.cat([a.to(torch.float32), rhs.to(torch.float32)], dim=2))
    x = take_rows(res.reduced[:, :, n:], res.perm)
    return _like(x[:, :, 0] if vector_input else x, a)


def det_batched(a: torch.Tensor) -> torch.Tensor:
    """Batched determinant: parity(pivot order) × Π pivot values."""
    res = gauss_jordan_tiled(a)
    return _like(_perm_parity(res.perm) * torch.prod(res.pivots, dim=-1), a)


def default_rank_tol(a: torch.Tensor) -> torch.Tensor:
    """``rank_batched``'s default per-matrix threshold for ``a [B, M, N]``.
    Gauss–Jordan residues are larger than an SVD's, so it is 100x the
    usual max(M, N)·eps·max|A| rank tolerance."""
    eps = torch.finfo(torch.float32).eps
    return max(a.shape[-2:]) * 100 * eps * a.to(torch.float32).abs().amax(
        dim=(1, 2))


def rank_batched(
    a: torch.Tensor, tol: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Batched numerical rank (pivots above a per-matrix tolerance
    ``tol [B]``); rectangular input is square-padded with zeros."""
    B, m, n = a.shape
    a32 = a.to(torch.float32)
    if m != n:
        size = max(m, n)
        padded = a32.new_zeros(B, size, size)
        padded[:, :m, :n] = a32
        a32 = padded
    if tol is None:
        tol = default_rank_tol(a32)
    res = gauss_jordan_tiled(a32, tol)
    return (res.pivots.abs() > 0).sum(dim=-1).to(torch.int32)
