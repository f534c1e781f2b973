"""Batched eigen stack on the device (counterpart of
``linalg_solver_tpu.ops.eigen``).

- **Characteristic polynomial** by Faddeev–LeVerrier: n batched
  products, no elimination.
- **Eigenvalues** by Wilkinson-shifted QR iteration on the full matrix
  (full-f32 Householder QR), complex-conjugate pairs read off the 2×2
  blocks left at the end; batched over the leading axis.
- **Eigenspaces** as nullspaces of A − λI on the Gauss–Jordan engine
  (``ops.solve``; at the spectral decomposition's scale kernel 3).
- **Multiplicities**: algebraic by tolerance clustering of the
  eigenvalues, geometric as n − rank(A − λI), the Weyr characteristic
  from the ranks of the powers (A − λI)^k.

Every product runs in full f32 (``f32_matmuls``), as the reference pins
``Precision.HIGHEST``.  Where the reference vmaps a single-matrix
function, the port runs the batch in one pass; the single-matrix names
call the batched ones on a batch of one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls
from .solve import (BatchedAffineSubspace, inverse_batched, nullspace_batched,
                    rank_batched, solve_affine_gj_batched,
                    solve_affine_gj_supported, solve_batched)


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.promote_types(a.dtype, torch.float32))


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _first(res):
    """Element 0 of every field of a batched NamedTuple result."""
    return type(res)(*(t[0] for t in res))


# ---------------------------------------------------------------------------
# Characteristic polynomial (Faddeev–LeVerrier)
# ---------------------------------------------------------------------------

def charpoly_batched(a: torch.Tensor) -> torch.Tensor:
    """Coefficients of ``p(λ) = det(λI − A)`` (monic), highest degree
    first, ``[..., n + 1]``, for ``a [..., n, n]``.

    Faddeev–LeVerrier:  M₁ = I;  cₖ = −tr(A·Mₖ)/k;  Mₖ₊₁ = A·Mₖ + cₖ·I."""
    a = _f32(a)
    n = a.shape[-1]
    eye = _eye(n, a)
    M = eye.expand_as(a)
    coeffs = [torch.ones(a.shape[:-2], dtype=a.dtype, device=a.device)]
    with f32_matmuls():
        for k in range(1, n + 1):
            AM = a @ M
            c = -AM.diagonal(dim1=-2, dim2=-1).sum(-1) / k
            M = AM + c[..., None, None] * eye
            coeffs.append(c)
    return torch.stack(coeffs, dim=-1)


def charpoly(a: torch.Tensor) -> torch.Tensor:
    """``charpoly_batched`` of one ``[n, n]`` matrix: ``[n + 1]``."""
    return charpoly_batched(a)


def charpoly_det_lambda(a: torch.Tensor) -> torch.Tensor:
    """``det(A − λI)`` coefficients (the exact path's sign convention):
    ``(−1)^n · p(λ)``, highest degree first."""
    return charpoly_batched(a) * ((-1) ** a.shape[-1])


# ---------------------------------------------------------------------------
# Eigenvalues: shifted QR iteration
# ---------------------------------------------------------------------------

class EigvalsResult(NamedTuple):
    real: torch.Tensor  # [..., n]
    imag: torch.Tensor  # [..., n]


def householder_qr(a: torch.Tensor):
    """Full-f32 QR of square matrices ``a [..., n, n]`` by Householder
    reflections (elementwise work and f32 matrix-vector products, one
    column a step): ``(Q, R)``."""
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device)
    R = a
    Qt = _eye(n, a).expand_as(a)
    with f32_matmuls():
        for k in range(n):
            xm = R[..., :, k] * (idx >= k).to(R.dtype)
            xk = R[..., k, k]
            alpha = -torch.sign(torch.where(xk == 0, 1.0, xk)) * torch.sqrt(
                (xm * xm).sum(-1))
            v = xm - alpha[..., None] * (idx == k).to(R.dtype)
            vnorm2 = (v * v).sum(-1)
            # a subnormal |v|² counts as zero, as in the reference, whose
            # arithmetic flushes subnormals (XLA on the CPU, the TPU):
            # 2/|v|² would overflow to inf and the update to NaN
            beta = torch.where(vnorm2 >= torch.finfo(R.dtype).tiny,
                               2.0 / vnorm2, 0.0)[..., None, None]
            vR = (v[..., None, :] @ R)                      # [..., 1, n]
            R = R - beta * v[..., :, None] * vR
            vQ = (v[..., None, :] @ Qt)
            Qt = Qt - beta * v[..., :, None] * vQ
    return Qt.transpose(-1, -2), R


def eigvals_qr_batched(a: torch.Tensor, iters: int = 100) -> EigvalsResult:
    """Eigenvalues of real matrices ``a [B, n, n]`` by Wilkinson-shifted
    QR, ``iters`` steps on every matrix (no deflation).

    The iteration converges to (quasi-)upper-triangular form: real
    eigenvalues are read off the diagonal, complex-conjugate pairs from
    the 2×2 diagonal blocks whose subdiagonal has not decayed."""
    a = _f32(a)
    n = a.shape[-1]
    if n == 1:
        return EigvalsResult(a[..., 0], torch.zeros_like(a[..., 0]))
    eye = _eye(n, a)
    A = a
    with f32_matmuls():
        for _ in range(iters):
            # Wilkinson shift from the trailing 2x2 block; a real shift
            # of t/2 where that block has complex eigenvalues
            p, q = A[..., n - 2, n - 2], A[..., n - 1, n - 1]
            t = p + q
            d = p * q - A[..., n - 2, n - 1] * A[..., n - 1, n - 2]
            disc = t * t / 4 - d
            sqrt_disc = torch.sqrt(torch.clamp(disc, min=0))
            mu1, mu2 = t / 2 + sqrt_disc, t / 2 - sqrt_disc
            mu = torch.where((mu1 - q).abs() < (mu2 - q).abs(), mu1, mu2)
            mu = torch.where(disc >= 0, mu, t / 2)[..., None, None]
            Q, R = householder_qr(A - mu * eye)
            A = R @ Q + mu * eye

    def roll(x, s):
        return torch.roll(x, s, dims=-1)

    zero = torch.zeros_like(A[..., :1, 0])
    diag = A.diagonal(dim1=-2, dim2=-1)
    sub = torch.cat([A.diagonal(-1, dim1=-2, dim2=-1), zero], dim=-1)
    up = torch.cat([A.diagonal(1, dim1=-2, dim2=-1), zero], dim=-1)
    nxt = roll(diag, -1)
    scale = diag.abs() + nxt.abs() + 1e-30
    eps = 100 * torch.finfo(A.dtype).eps
    live_sub = sub.abs() > eps * scale     # True at i: a block (i, i + 1)

    # the eigenvalues of the block [[a, b], [c, d]] starting at i
    tr2 = diag + nxt
    det2 = diag * nxt - up * sub
    disc2 = tr2 * tr2 / 4 - det2
    re_pair = tr2 / 2
    im_pair = torch.sqrt(torch.clamp(-disc2, min=0))
    sq = torch.sqrt(torch.clamp(disc2, min=0))

    # is_second[i]: the block starts at i - 1
    is_second = torch.cat([torch.zeros_like(live_sub[..., :1]),
                           live_sub[..., :-1]], dim=-1)
    is_first = live_sub & ~is_second
    real = torch.where(is_first, re_pair, diag)
    real = torch.where(is_second, roll(re_pair, 1), real)
    # a real 2x2 block that never decoupled: its two real roots; a
    # complex block: the conjugate pair
    real = torch.where(is_first & (disc2 >= 0), re_pair + sq, real)
    real = torch.where(is_second & (roll(disc2, 1) >= 0),
                       roll(re_pair - sq, 1), real)
    imag = torch.where(is_first & (disc2 < 0), im_pair, 0.0)
    imag = torch.where(is_second & (roll(disc2, 1) < 0),
                       -roll(im_pair, 1), imag)
    return EigvalsResult(real, imag)


def eigvals_qr(a: torch.Tensor, iters: int = 100) -> EigvalsResult:
    """``eigvals_qr_batched`` of one ``[n, n]`` matrix."""
    return _first(eigvals_qr_batched(a[None], iters=iters))


# ---------------------------------------------------------------------------
# Multiplicities & eigenspaces
# ---------------------------------------------------------------------------

def algebraic_multiplicities(real: torch.Tensor, imag: torch.Tensor,
                             tol: float = 1e-3) -> torch.Tensor:
    """For each eigenvalue slot i (last axis), the count of eigenvalues
    within ``tol`` (itself included): the algebraic multiplicity of its
    cluster (int32)."""
    dr = real[..., :, None] - real[..., None, :]
    di = imag[..., :, None] - imag[..., None, :]
    return (dr * dr + di * di <= tol * tol).sum(dim=-1).to(torch.int32)


def _shift(a: torch.Tensor, eigenvalue: torch.Tensor) -> torch.Tensor:
    """``a[b] − eigenvalue[b]·I`` for ``a [B, n, n]``, ``eigenvalue [B]``."""
    ev = torch.as_tensor(eigenvalue, dtype=a.dtype, device=a.device)
    return a - ev.reshape(-1, 1, 1) * _eye(a.shape[-1], a)


def eigenspace_batched(a: torch.Tensor, eigenvalue: torch.Tensor,
                       tol: float = 1e-4) -> BatchedAffineSubspace:
    """Nullspaces of ``a[b] − eigenvalue[b]·I`` (partial pivoting)."""
    return nullspace_batched(_shift(a, eigenvalue), tol=tol,
                             pivot_rule="partial")


def eigenspace(a: torch.Tensor, eigenvalue, tol: float = 1e-4
               ) -> BatchedAffineSubspace:
    """Nullspace of ``A − λI`` for one ``[n, n]`` matrix."""
    return _first(eigenspace_batched(a[None], eigenvalue, tol=tol))


def geometric_multiplicity(a: torch.Tensor, eigenvalue,
                           tol: Optional[float] = None) -> torch.Tensor:
    """n − rank(A − λI) of one ``[n, n]`` matrix."""
    return a.shape[-1] - rank_batched(_shift(a[None], eigenvalue),
                                      tol=tol)[0]


def weyr_characteristic_batched(a: torch.Tensor, eigenvalue: torch.Tensor,
                                k_max: int, tol: Optional[float] = None
                                ) -> torch.Tensor:
    """``w_k = rank((A − λI)^{k−1}) − rank((A − λI)^k)`` for k = 1..k_max,
    ``[B, k_max]`` int32.  ``w_1`` is the geometric multiplicity (the
    number of Jordan blocks of λ), ``w_k − w_{k+1}`` the number of blocks
    of size exactly k, ``Σ w_k`` over the full range the algebraic
    multiplicity."""
    shifted = _shift(a, eigenvalue)
    n = shifted.shape[-1]
    P = _eye(n, shifted).expand_as(shifted)
    ranks = []
    for _ in range(k_max):
        with f32_matmuls():
            P = P @ shifted
        ranks.append(rank_batched(P, tol=tol))
    ranks = torch.stack(ranks, dim=1)
    prev = torch.cat([torch.full_like(ranks[:, :1], n), ranks[:, :-1]], dim=1)
    return (prev - ranks).to(torch.int32)


def weyr_characteristic(a: torch.Tensor, eigenvalue, k_max: int,
                        tol: Optional[float] = None) -> torch.Tensor:
    """``weyr_characteristic_batched`` of one ``[n, n]`` matrix."""
    return weyr_characteristic_batched(a[None], eigenvalue, k_max, tol=tol)[0]


# ---------------------------------------------------------------------------
# Diagonalization
# ---------------------------------------------------------------------------

class DiagonalizationDevResult(NamedTuple):
    """Device diagonalization ``A = P · diag(eigenvalues) · P⁻¹``."""

    eigenvalues: torch.Tensor   # [..., n] real parts (sorted descending)
    eig_imag: torch.Tensor      # [..., n] imaginary parts
    alg_mult: torch.Tensor      # [..., n] per-slot algebraic multiplicities
    P: torch.Tensor             # [..., n, n] eigenvector columns
    P_inv: torch.Tensor         # [..., n, n]
    D: torch.Tensor             # [..., n, n]
    success: torch.Tensor       # [...] bool


def _clusters(lam, lam_im, tol):
    """Per slot of ``lam``, ``lam_im [B, n]``: the size of its cluster
    (the eigenvalues within ``tol``) and the cluster's mean."""
    dr = lam[:, :, None] - lam[:, None, :]
    di = lam_im[:, :, None] - lam_im[:, None, :]
    close = (dr * dr + di * di <= tol * tol).to(lam.dtype)
    with f32_matmuls():
        mean = (close @ lam[:, :, None])[:, :, 0] / close.sum(dim=2)
    return close.sum(dim=2).to(torch.int32), mean


def _sort_desc(ev_real, ev_imag, dtype):
    """Slots sorted by descending real part, ties in input order (the
    reference's stable ``argsort``)."""
    order = torch.sort(-ev_real, dim=-1, stable=True).indices
    return (torch.gather(ev_real.to(dtype), -1, order),
            torch.gather(ev_imag.to(dtype), -1, order))


def diagonalize_batched(a: torch.Tensor, iters: int = 100, tol: float = 1e-4,
                        space_tol: float = 1e-3,
                        eigvals: Optional[EigvalsResult] = None
                        ) -> DiagonalizationDevResult:
    """Numeric diagonalization over the reals of ``a [B, n, n]``.

    Each eigenvalue is refined to the mean of its cluster (radius
    ``tol``), so that exact multiple eigenvalues whose QR estimates split
    by O(√eps) show a genuinely defective matrix as a rank-deficient
    eigenspace.  Every slot's eigenspace is the Gauss–Jordan nullspace of
    A − λI at pivot threshold ``space_tol``; the first slot of each
    cluster contributes its normalized generators to P, in order.
    Success iff P gets n columns, every eigenvalue is real and P
    inverts."""
    a = _f32(a)
    bsz, n, _ = a.shape
    ev = eigvals_qr_batched(a, iters=iters) if eigvals is None else eigvals
    lam, lam_im = _sort_desc(ev.real, ev.imag, a.dtype)
    all_real = (lam_im.abs() <= tol).all(dim=1)
    alg, lam_refined = _clusters(lam, lam_im, tol)

    # every slot's eigenspace: [B·n] nullspaces of [n, n]
    spaces = eigenspace_batched(a.repeat_interleave(n, dim=0),
                                lam_refined.reshape(-1), tol=space_tol)
    gens = spaces.generators.reshape(bsz, n, n, n)     # [B, slot, i, j]
    first = torch.ones(bsz, n, dtype=torch.bool, device=a.device)
    first[:, 1:] = ~((lam - torch.roll(lam, 1, dims=1)).abs() <= tol)[:, 1:]
    mask = spaces.gen_mask.reshape(bsz, n, n) & first[:, :, None]

    # the valid columns in (slot, column) order go to P's columns
    # 0, 1, ...; past n - 1 each lands on column n - 1, the last one
    # staying, as the reference's clamped dynamic update leaves it
    flat = mask.reshape(bsz, n * n)
    idx = torch.cumsum(flat, dim=1) - 1
    count = flat.sum(dim=1)
    keep = flat & ((idx < n - 1) | (idx == (count - 1)[:, None]))
    dest = torch.where(keep, idx.clamp(max=n - 1), n)
    cols = gens.permute(0, 1, 3, 2).reshape(bsz, n * n, n)   # [B, (s, j), i]
    norm = torch.sqrt((cols * cols).sum(dim=2, keepdim=True))
    cols = cols / torch.where(norm > 0, norm, 1.0)
    Pt = torch.zeros(bsz, n + 1, n, dtype=a.dtype, device=a.device)
    Pt.scatter_(1, dest[:, :, None].expand(bsz, n * n, n), cols)
    P = Pt[:, :n].transpose(1, 2)

    success = (count == n) & all_real
    eye = _eye(n, a)
    inv = inverse_batched(torch.where(success[:, None, None], P, eye),
                          tol=1e-30, pivot_rule="partial")
    success = success & inv.is_invertible
    with f32_matmuls():
        D = inv.inverse @ a @ P
    return DiagonalizationDevResult(lam, lam_im, alg, P, inv.inverse, D,
                                    success)


def diagonalize(a: torch.Tensor, iters: int = 100, tol: float = 1e-4,
                space_tol: float = 1e-3,
                eigvals: Optional[EigvalsResult] = None
                ) -> DiagonalizationDevResult:
    """``diagonalize_batched`` of one ``[n, n]`` matrix."""
    if eigvals is not None:
        eigvals = EigvalsResult(eigvals.real[None], eigvals.imag[None])
    return _first(diagonalize_batched(a[None], iters=iters, tol=tol,
                                      space_tol=space_tol, eigvals=eigvals))


# ---------------------------------------------------------------------------
# Batched spectral decomposition (distinct-eigenvalue compaction)
# ---------------------------------------------------------------------------

class SpectralDecomposition(NamedTuple):
    """Batched eigen-analysis: per-slot eigenvalues (sorted by descending
    real part) with algebraic and geometric multiplicities, and the
    diagonalization ``A = P D P⁻¹`` where it exists."""

    eigenvalues: torch.Tensor   # [B, n] real parts
    eig_imag: torch.Tensor      # [B, n]
    alg_mult: torch.Tensor      # [B, n]
    geom_mult: torch.Tensor     # [B, n]
    P: torch.Tensor             # [B, n, n]
    P_inv: torch.Tensor         # [B, n, n]
    D: torch.Tensor             # [B, n, n]
    success: torch.Tensor       # [B]


def _nullspaces(shifted: torch.Tensor, tol: torch.Tensor
                ) -> BatchedAffineSubspace:
    """Nullspaces of the shifted stack ``[S, n, n]`` at per-matrix
    ``tol [S]``: kernel 3 within its big reach (on a CPU tensor its plain
    version), the blocked RREF from n = 256 past it, else the loop."""
    n = shifted.shape[-1]
    zeros = torch.zeros(shifted.shape[:2], dtype=shifted.dtype,
                        device=shifted.device)
    if solve_affine_gj_supported(n, n):
        return solve_affine_gj_batched(shifted, zeros, tol=tol)
    if n >= 256:
        from .rref_blocked import solve_affine_blocked_batched

        return solve_affine_blocked_batched(shifted, zeros, tol=tol)
    return solve_batched(shifted, zeros, tol=tol, pivot_rule="partial")


def _place_columns(Q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``P [bc, n, n]`` from the K cluster bases ``Q [bc, K, n, n]`` (the
    first ``g [bc, K]`` columns valid): cluster k's column t goes to
    column ``Σ_{k' < k} g_k' + t`` of P, where that is below n."""
    bc, K, n, _ = Q.shape
    offset = torch.cumsum(g, dim=1) - g                       # [bc, K]
    t = torch.arange(n, device=Q.device)
    col = offset[:, :, None] + t                              # [bc, K, n]
    valid = (t < g[:, :, None]) & (col < n)
    dest = torch.where(valid, col, n).reshape(bc, K * n)
    src = Q.permute(0, 1, 3, 2).reshape(bc, K * n, n)         # [bc, (k, t), i]
    Pt = torch.zeros(bc, n + 1, n, dtype=Q.dtype, device=Q.device)
    Pt.scatter_(1, dest[:, :, None].expand(bc, K * n, n), src)
    return Pt[:, :n].transpose(1, 2)


def spectral_decompose_batched(
    a: torch.Tensor,
    ev_real: torch.Tensor,
    ev_imag: torch.Tensor,
    tol: float = 1e-3,
    space_tol: Optional[float] = None,
    max_distinct: Optional[int] = None,
    success_tol: Optional[float] = None,
) -> SpectralDecomposition:
    """Multiplicities and diagonalization of ``a [B, n, n]`` given its
    eigenvalues ``ev_real``, ``ev_imag [B, n]``.

    The eigenvalues are clustered (radius ``tol``, refined to the
    cluster means), the distinct values compacted to ``K =
    max_distinct`` slots (default n, exact), and ONE batched Gauss–Jordan
    nullspace pass over the ``[B·K]`` shifted matrices (kernel 3) gives
    both the geometric multiplicities and the eigenvector bases.
    Clusters past ``max_distinct`` get no eigenspace: their ``geom_mult``
    reads 0 and ``success`` is False.

    ``space_tol`` (the nullspace threshold relative to ``max(max|A|,
    1)``) defaults to ``max(tol/10, 10·n·eps)``: tighter than the
    clustering radius, since a cluster mean is more accurate than its
    members and the eigenvector contamination scales with
    space_tol/gap.  A cluster whose tight-pass nullity falls short of its
    size takes the loose pass at ``tol`` (a defective cluster falls short
    under both).  The batch runs in chunks of ``2^26 / (K·n·n)``
    matrices, two kernel launches a chunk, as the reference's.  ``P⁻¹``
    comes from ``dispatch.inverse_batched(auto)`` and ``success`` needs
    ``max|P·P⁻¹ − I| < success_tol`` (default ``max(1e-2, 3·tol)``).

    Where a cluster's basis is non-finite, its columns of P are; the
    reference's one-hot product spreads the NaN over the lane's P.  The
    flags agree: such a lane fails its residual check either way."""
    from . import dispatch
    from .orth import orthonormal_columns

    a = _f32(a)
    bsz, n, _ = a.shape
    dev, dtype = a.device, a.dtype
    K = n if max_distinct is None else min(max_distinct, n)
    if space_tol is None:
        # in f32, as the reference computes it from its f32 ``tol``
        space_tol = float(torch.clamp(
            torch.tensor(tol, dtype=torch.float32) / 10.0,
            min=10 * n * torch.finfo(torch.float32).eps))

    lam, lam_im = _sort_desc(ev_real, ev_imag, dtype)
    all_real = (lam_im.abs() <= tol).all(dim=1)

    # cluster: algebraic multiplicities and refined cluster means
    alg, lam_ref = _clusters(lam, lam_im, tol)

    # distinct compaction: each slot's cluster index; the first slot of
    # each cluster gives its value to the cluster's column
    same_prev = (((lam - torch.roll(lam, 1, dims=1)).abs() <= tol)
                 & ((lam_im - torch.roll(lam_im, 1, dims=1)).abs() <= tol))
    first = torch.ones(bsz, n, dtype=torch.bool, device=dev)
    first[:, 1:] = ~same_prev[:, 1:]
    pos = torch.cumsum(first, dim=1) - 1                      # [B, n]
    in_k = pos < K
    pos_k = pos.clamp(max=K - 1)
    head = (first & in_k).to(dtype)
    dvals = torch.zeros(bsz, K, dtype=dtype, device=dev).scatter_add_(
        1, pos_k, lam_ref * head)
    dmask = torch.zeros(bsz, K, dtype=dtype, device=dev).scatter_add_(
        1, pos_k, head) > 0.5                                 # [B, K]
    csize = torch.zeros(bsz, K, dtype=torch.int32, device=dev).scatter_add_(
        1, pos_k, in_k.to(torch.int32))                       # cluster sizes

    # one nullspace per distinct eigenvalue, in chunks of the batch, two
    # passes: the tight one where it finds the whole cluster, else the
    # loose one at the clustering radius
    eye = _eye(n, a)
    amag = torch.clamp(a.abs().amax(dim=(1, 2)), min=1.0)
    rank_tol, rank_tol_loose = space_tol * amag, tol * amag
    bchunk = max(1, (1 << 26) // max(K * n * n, 1))
    P = torch.zeros(bsz, n, n, dtype=dtype, device=dev)
    count = torch.zeros(bsz, dtype=torch.int32, device=dev)
    dims_all = torch.zeros(bsz, K, dtype=torch.int32, device=dev)
    for b0 in range(0, bsz, bchunk):
        sl = slice(b0, min(b0 + bchunk, bsz))
        bc = sl.stop - b0
        shifted = (a[sl].repeat_interleave(K, dim=0)
                   - dvals[sl].reshape(bc * K)[:, None, None] * eye)

        def null_pass(tol_b):
            sub = _nullspaces(shifted, tol_b.repeat_interleave(K))
            return (sub.generators.reshape(bc, K, n, n),
                    sub.gen_mask.reshape(bc, K, n) & dmask[sl][:, :, None])

        gens_t, gmask_t = null_pass(rank_tol[sl])
        gens_l, gmask_l = null_pass(rank_tol_loose[sl])
        del shifted
        use_t = gmask_t.sum(dim=2) >= csize[sl]                # [bc, K]
        gens = torch.where(use_t[:, :, None, None], gens_t, gens_l)
        gmask = torch.where(use_t[:, :, None], gmask_t, gmask_l)
        del gens_t, gens_l
        dims_all[sl] = gmask.sum(dim=2).to(torch.int32)
        # every cluster basis orthonormalized in one [bc·K] batch
        Q, g = orthonormal_columns(gens.reshape(bc * K, n, n),
                                   gmask.reshape(bc * K, n))
        del gens
        g = g.reshape(bc, K)
        P[sl] = _place_columns(Q.reshape(bc, K, n, n), g)
        count[sl] = g.sum(dim=1).to(torch.int32)
        del Q

    # each slot's geometric multiplicity: the dimension of its cluster's
    # eigenspace (0 past max_distinct)
    geom = torch.where(in_k, torch.gather(dims_all, 1, pos_k), 0)
    success = all_real & (count == n)

    P_safe = torch.where(success[:, None, None], P, eye)
    P_inv = dispatch.inverse_batched(P_safe, backend="auto")
    with f32_matmuls():
        resid = (P_safe @ P_inv - eye).abs().amax(dim=(1, 2))
        D = P_inv @ a @ P_safe
    if success_tol is None:
        success_tol = max(1e-2, 3.0 * tol)
    success = success & torch.isfinite(resid) & (resid < success_tol)
    return SpectralDecomposition(lam, lam_im, alg, geom.to(torch.int32),
                                 P_safe, P_inv, D, success)
