"""Ordered Schur forms: rsf2csf, batched eigenvalue reordering, invariant
subspaces and cluster condition numbers (counterpart of
``linalg_solver_tpu.ops.ordschur``; LAPACK ``dtrexc``/``dtrsen``, MATLAB
``ordschur``).

1. ``rsf2csf_batched`` turns the real quasi-triangular Schur form into a
   complex upper-triangular one (scipy ``rsf2csf``): every 2×2
   complex-pair block is rotated by one complex 2×2 unitary, all blocks
   in one similarity.  Every diagonal entry is then an eigenvalue and an
   adjacent swap is one complex Givens rotation.
2. The reorder is an odd–even transposition sort on the diagonal: sweep
   ``s`` rotates every disjoint adjacent pair of parity ``s % 2`` whose
   keys are out of order, all at once.  The comparator is strict, so the
   sort is stable and conjugate pairs keep their order.  The sweeps run
   to their bound (``n``), as the reference's ``fori_loop`` does.

Swapping ``λ₁, λ₂`` with coupling ``t``: ``v = [t, λ₂ − λ₁]`` is the
eigenvector for ``λ₂`` and ``U = [v, v⊥]/‖v‖`` swaps the pair with
``|t'| = |t|``; ``v = 0`` (equal eigenvalues, zero coupling) leaves
``T`` alone and only the bookkeeping swaps.

The port carries the complex forms as native complex tensors inside and
returns (re, im) pairs, the reference's fields.  The cluster condition
numbers solve the masked triangular Sylvester equation on
``kernels.trsyl`` (a hand-written kernel on the card, where the reference
runs a nested XLA scan); the sep estimate's random start is an argument
(``u0``, or a ``torch.Generator``; ``utils.draws``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils import draws
from ..utils.precision import f32_matmuls
from .kernels import trsyl
from .schur import (
    SchurVectors,
    _standardize_real_blocks,
    _tridiag_parts,
    real_schur_vectors,
)


class ComplexSchur(NamedTuple):
    """Complex Schur form ``A = Q T Qᴴ`` on (re, im) pairs: ``T`` upper
    triangular with the eigenvalues on the diagonal, ``Q`` unitary."""

    t_re: torch.Tensor  # [B, n, n]
    t_im: torch.Tensor
    q_re: torch.Tensor
    q_im: torch.Tensor


def _cdtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _pairs(t: torch.Tensor, q: torch.Tensor):
    return (t.real.contiguous(), t.imag.contiguous(), q.real.contiguous(),
            q.imag.contiguous())


@f32_matmuls()
def _complex_schur(T: torch.Tensor, Q: torch.Tensor):
    """``rsf2csf`` as complex tensors ``(T_c, Q_c)``."""
    T, Q = _standardize_real_blocks(T, Q)
    B, n, _ = T.shape
    dtype = T.dtype
    idx = torch.arange(n, device=T.device)
    diag, sub, sup = _tridiag_parts(T)
    sub_prev = F.pad(sub[:, :-1], (1, 0))
    a, d, c = diag, F.pad(diag[:, 1:], (0, 1)), sub
    half = (a - d) / 2
    disc = half * half + sup * c
    top = (sub != 0) & (sub_prev == 0) & (disc < 0)       # [B, n]
    nu = torch.sqrt(torch.clamp(-disc, min=0.0))
    mu = (a + d) / 2
    # unit eigenvector v = [half + i·nu, c] of the block for mu + i·nu
    nrm = torch.sqrt(half * half + nu * nu + c * c)
    nrm = torch.where(nrm > 0, nrm, 1.0)
    u0r, u0i, u1 = half / nrm, nu / nrm, c / nrm
    bot = F.pad(top[:, :-1], (1, 0))
    eye_m = (idx[:, None] == idx[None, :]).to(dtype)
    up_m = (idx[:, None] + 1 == idx[None, :]).to(dtype)
    lo_m = (idx[:, None] == idx[None, :] + 1).to(dtype)
    # G = I except per block: [[u0, -u1], [u1, conj(u0)]]
    dvec_r = torch.where(top, u0r, 1.0)
    dvec_i = torch.where(top, u0i, 0.0)
    dvec_r = torch.where(bot, torch.roll(u0r, 1, 1), dvec_r)
    dvec_i = torch.where(bot, -torch.roll(u0i, 1, 1), dvec_i)
    off = torch.where(top, u1, 0.0)
    g_re = (eye_m * dvec_r[:, :, None] - up_m * off[:, :, None]
            + lo_m * off[:, None, :])
    G = torch.complex(g_re, eye_m * dvec_i[:, :, None])
    # T_c = Gᴴ T G, Q_c = Q G
    cd = _cdtype(dtype)
    t = G.mH @ T.to(cd) @ G
    q = Q.to(cd) @ G
    # exact structure: strictly lower zero, the blocks' eigenvalues exact
    t = t.masked_fill(torch.ones(n, n, dtype=torch.bool, device=T.device)
                      .tril(-1), 0)
    w_re = torch.where(top | bot, torch.where(top, mu, torch.roll(mu, 1, 1)),
                       diag)
    w_im = torch.where(top, nu, torch.where(bot, -torch.roll(nu, 1, 1), 0.0))
    t.diagonal(0, 1, 2).copy_(torch.complex(w_re, w_im))
    return t, q


def rsf2csf_batched(T: torch.Tensor, Q: torch.Tensor) -> ComplexSchur:
    """Real quasi-triangular Schur form → complex upper-triangular Schur
    form (scipy ``rsf2csf``), batched.  Real-eigenvalue 2×2 blocks are
    split orthogonally first; each complex-pair block ``[[a, b], [c, d]]``
    (eigenvalues ``μ ± iν``) is rotated by the unitary built from its unit
    eigenvector ``[(a − d)/2 + iν, c]/‖·‖``, ``μ + iν`` first."""
    return ComplexSchur(*_pairs(*_complex_schur(T, Q)))


def _reorder_sweeps(t: torch.Tensor, q: torch.Tensor, keys: torch.Tensor,
                    sweeps: int):
    """Odd–even transposition sort of the complex Schur diagonal by
    descending ``keys`` (strict comparator, so stable).  Returns the
    reordered ``(t, q)``; the inputs are left as they were."""
    B, n, _ = t.shape
    tiny = torch.finfo(keys.dtype).tiny * 1e4
    t, q, keys = t.clone(), q.clone(), keys.clone()
    tril = torch.ones(n, n, dtype=torch.bool, device=t.device).tril(-1)
    for s in range(sweeps):
        p = s % 2
        k = len(range(p, n - 1, 2))
        if k == 0:
            continue
        top, bot = slice(p, p + 2 * k, 2), slice(p + 1, p + 2 * k, 2)
        lam = t.diagonal(0, 1, 2).clone()
        l1, l2 = lam[:, top], lam[:, bot]
        t12 = t.diagonal(1, 1, 2)[:, top]
        want = keys[:, top] < keys[:, bot]
        # v = [t12, λ₂ − λ₁]; U = [v, v⊥]/‖v‖ (v = 0 → U = I)
        d = l2 - l1
        nrm2 = t12.real ** 2 + t12.imag ** 2 + d.real ** 2 + d.imag ** 2
        ok_v = nrm2 > tiny
        nrm = torch.sqrt(torch.where(ok_v, nrm2, 1.0))
        do = want & ok_v
        u0 = torch.where(do, torch.complex(t12.real / nrm, t12.imag / nrm),
                         torch.ones_like(t12))
        u1 = torch.where(do, torch.complex(d.real / nrm, d.imag / nrm),
                         torch.zeros_like(t12))
        # rows M ← Uᴴ M: row_i = conj(u0) M_i + conj(u1) M_{i+1},
        # row_{i+1} = −u1 M_i + u0 M_{i+1}
        r0, r1 = t[:, top, :], t[:, bot, :]
        new0 = u0.conj()[:, :, None] * r0 + u1.conj()[:, :, None] * r1
        new1 = -u1[:, :, None] * r0 + u0[:, :, None] * r1
        t[:, top, :], t[:, bot, :] = new0, new1
        # columns M ← M U: col_i = u0 M_i + u1 M_{i+1},
        # col_{i+1} = −conj(u1) M_i + conj(u0) M_{i+1}
        for M in (t, q):
            c0, c1 = M[:, :, top], M[:, :, bot]
            new0 = c0 * u0[:, None, :] + c1 * u1[:, None, :]
            new1 = -c0 * u1.conj()[:, None, :] + c1 * u0.conj()[:, None, :]
            M[:, :, top], M[:, :, bot] = new0, new1
        # the bookkeeping swaps by `want` (a v = 0 pair swaps trivially)
        k0, k1 = keys[:, top].clone(), keys[:, bot].clone()
        keys[:, top] = torch.where(want, k1, k0)
        keys[:, bot] = torch.where(want, k0, k1)
        lam[:, top], lam[:, bot] = (torch.where(want, l2, l1),
                                    torch.where(want, l1, l2))
        # exact structure: triangular, the swapped diagonal exact
        t.masked_fill_(tril, 0)
        t.diagonal(0, 1, 2).copy_(lam)
    return t, q


class OrderedSchur(NamedTuple):
    """Reordered complex Schur form of a real matrix batch (on (re, im)
    pairs): ``A = Q T Qᴴ`` with the selected (or key-sorted) eigenvalues
    leading.  ``m`` counts the selected eigenvalues a lane (``n`` in sort
    mode); the first ``m`` columns of ``Q`` span their invariant
    subspace."""

    t_re: torch.Tensor   # [B, n, n]
    t_im: torch.Tensor
    q_re: torch.Tensor
    q_im: torch.Tensor
    w_re: torch.Tensor   # [B, n] reordered eigenvalues (= diag T)
    w_im: torch.Tensor
    m: torch.Tensor      # [B] int32


def _ordered(t, q, m) -> OrderedSchur:
    w = t.diagonal(0, 1, 2)
    return OrderedSchur(*_pairs(t, q), w.real.contiguous(),
                        w.imag.contiguous(), m)


def schur_reorder_batched(T: torch.Tensor, Q: torch.Tensor,
                          select: torch.Tensor, sweeps: int = 0
                          ) -> OrderedSchur:
    """MATLAB-``ordschur`` analogue: given a REAL Schur pair ``(T, Q)``
    (e.g. from ``ops.schur.real_schur_vectors``) and a boolean ``select
    [B, n]`` over its diagonal positions, the complex Schur form with the
    selected eigenvalues moved to the top left.  ``select`` is made
    symmetric over 2×2 conjugate-pair blocks (a pair is selected if either
    position is): a real invariant subspace cannot split a pair."""
    B, n, _ = T.shape
    _, sub, _ = _tridiag_parts(T)
    pair_top = (sub != 0) & (F.pad(sub[:, :-1], (1, 0)) == 0)
    sel = select.to(torch.bool)
    sel = torch.where(pair_top, sel | F.pad(sel[:, 1:], (0, 1)), sel)
    pair_bot = F.pad(pair_top[:, :-1], (1, 0))
    sel = torch.where(pair_bot, torch.roll(sel, 1, 1), sel)
    t, q = _complex_schur(T, Q)
    t, q = _reorder_sweeps(t, q, sel.to(T.dtype), sweeps or n)
    return _ordered(t, q, sel.sum(dim=1).to(torch.int32))


_SORT_KEYS = ("abs_desc", "abs_asc", "real_desc", "real_asc")


def schur_sort_batched(T: torch.Tensor, Q: torch.Tensor,
                       key: str = "abs_desc", sweeps: int = 0
                       ) -> OrderedSchur:
    """Sort the Schur diagonal by an eigenvalue key: ``abs_desc`` /
    ``abs_asc`` (|λ|), ``real_desc`` / ``real_asc`` (Re λ).  The sort is
    stable, so conjugate pairs (equal keys) stay adjacent with the
    ``+iν`` member first."""
    if key not in _SORT_KEYS:
        raise ValueError(f"key must be one of {_SORT_KEYS}")
    B, n, _ = T.shape
    t, q = _complex_schur(T, Q)
    w = t.diagonal(0, 1, 2)
    k = (torch.sqrt(w.real * w.real + w.imag * w.imag)
         if key.startswith("abs") else w.real.clone())
    if key.endswith("asc"):
        k = -k
    t, q = _reorder_sweeps(t, q, k, sweeps or n)
    return _ordered(t, q, torch.full((B,), n, dtype=torch.int32,
                                     device=T.device))


class InvariantSubspace(NamedTuple):
    """Real orthonormal basis of the invariant subspace of a selected,
    conjugation-closed eigenvalue set: the first ``m[b]`` columns of
    ``v[b]`` (the rest exactly zero).  ``w_re/w_im`` are all eigenvalues,
    selected first; ``resid`` is each lane's relative invariance defect
    ``‖A V − V (VᵀA V)‖_F / ‖A‖_F``."""

    v: torch.Tensor          # [B, n, n]
    m: torch.Tensor          # [B] int32
    w_re: torch.Tensor       # [B, n]
    w_im: torch.Tensor
    resid: torch.Tensor      # [B]
    ok: torch.Tensor         # [B]
    converged: torch.Tensor  # [B] eigensolver flag


def invariant_subspace_batched(
    a: torch.Tensor, select_fn: Callable, max_sweeps: int = 0,
    chunk: int = 64, balance: bool = True, tol: float = 1e-3,
) -> InvariantSubspace:
    """Orthonormal basis of the invariant subspace of each ``A`` spanned
    by the eigenvalues ``select_fn(w_re, w_im) -> bool [B, n]`` picks (e.g.
    ``lambda re, im: re < 0`` for the stable subspace).  The selection
    must be closed under conjugation (``select_fn`` sees exact conjugate
    pairs, so any function of ``(re, |im|)`` is safe); pairs are made
    whole defensively.

    Pipeline: ``ops.schur.real_schur_vectors`` → complex reorder → undo
    the balancing on the leading columns → the real span as the
    orthonormalized ``[Re | Im]`` of the leading complex columns (the 2m
    candidates span exactly m real dimensions), checked by the returned
    invariance residual."""
    sv = real_schur_vectors(a, max_sweeps=max_sweeps, chunk=chunk,
                            balance=balance)
    return _invariant_subspace_from_schur(a, sv, select_fn, tol)


@f32_matmuls()
def _invariant_subspace_from_schur(a, sv: SchurVectors, select_fn, tol):
    from .orth import orthonormal_columns
    from .spd import pivoted_cholesky_batched

    B, n, _ = a.shape
    dtype = sv.T.dtype
    t, q = _complex_schur(sv.T, sv.Q)
    w = t.diagonal(0, 1, 2)
    w_re, w_im = w.real, w.imag
    sel = torch.as_tensor(select_fn(w_re, w_im), device=a.device).to(
        torch.bool)
    # conjugate closure: a pair is (λ at i, λ̄ at i+1)
    pair = ((w_im != 0) & (w_im == -torch.roll(w_im, -1, 1))
            & (w_re == torch.roll(w_re, -1, 1)))
    sel = torch.where(pair, sel | F.pad(sel[:, 1:], (0, 1)), sel)
    sel = torch.where(F.pad(pair[:, :-1], (1, 0)), torch.roll(sel, 1, 1), sel)
    t, q = _reorder_sweeps(t, q, sel.to(dtype), n)
    m = sel.sum(dim=1).to(torch.int32)
    colmask = torch.arange(n, device=a.device)[None, :] < m[:, None]  # [B, n]

    # un-balance: the Schur form is of D A D⁻¹, so invariant columns of A
    # are D⁻¹ q (span kept; orthonormality restored below)
    qs = q * (1.0 / sv.scale)[:, :, None] * colmask[:, None, :]
    # real span: [Re | Im] has real rank m for a conjugation-closed set;
    # pick m independent columns by pivoted Cholesky on the Gram matrix
    X = torch.cat([qs.real, qs.imag], dim=2)               # [B, n, 2n]
    pc = pivoted_cholesky_batched(X.transpose(1, 2) @ X)
    piv = pc.piv[:, :n].to(torch.int64)
    cand = torch.gather(X, 2, piv[:, None, :].expand(B, n, n))
    cand = torch.where(colmask[:, None, :], cand, 0.0)
    V, _ = orthonormal_columns(cand, colmask)

    # invariance defect R = A V − V (Vᵀ A V) on the masked columns
    a = a.to(dtype)
    AV = a @ V
    Hm = (V.transpose(1, 2) @ AV) * colmask[:, :, None] * colmask[:, None, :]
    R = (AV - V @ Hm) * colmask[:, None, :]
    anorm = torch.sqrt((a * a).sum(dim=(1, 2)))
    resid = torch.sqrt((R * R).sum(dim=(1, 2))) / torch.clamp(
        anorm, min=torch.finfo(dtype).tiny)
    ok = (resid < tol) & sv.converged
    w = t.diagonal(0, 1, 2)
    return InvariantSubspace(V, m, w.real.contiguous(), w.imag.contiguous(),
                             resid, ok, sv.converged)


class ClusterCondition(NamedTuple):
    """dtrsen-style condition numbers of a selected eigenvalue cluster
    (each a lane):

    - ``s``: reciprocal condition of the cluster average,
      ``1/√(1 + ‖X‖²_F)`` with ``T11 X − X T22 = T12``;
    - ``sep``: estimated ``sep(T11, T22) = σ_min(Z ↦ T11 Z − Z T22)``
      (power iteration on the inverse operator, from above);
    - ``p_fro``: Frobenius norm of the spectral projector ``√(m + ‖X‖²_F)``;
    - ``gap``: ``min |λ_sel − λ_unsel|`` (``sep ≤ gap``);
    - ``perturbed``: a shared or nearly shared eigenvalue between the
      clusters forced an ``eps·‖T‖`` denominator floor.
    """

    s: torch.Tensor          # [B]
    sep: torch.Tensor        # [B]
    p_fro: torch.Tensor      # [B]
    gap: torch.Tensor        # [B]
    m: torch.Tensor          # [B] int32
    perturbed: torch.Tensor  # [B] bool


def schur_cluster_cond_batched(
    T: torch.Tensor, Q: torch.Tensor, select: torch.Tensor,
    sep_iters: int = 5, u0=None,
    generator: Optional[torch.Generator] = None,
) -> ClusterCondition:
    """Condition numbers of the eigenvalue cluster ``select`` picks (a
    [B, n] mask over the diagonal positions of the REAL Schur form ``T``):
    LAPACK ``dtrsen`` job='B''s quantities, batched.

    Pipeline: complex reorder (selected first), one masked triangular
    Sylvester solve for ``s`` and ``p_fro``, and ``sep_iters`` inverse
    power iterations (a forward and an adjoint solve each) for ``sep``:
    ``1 + 2·sep_iters`` launches of ``kernels.trsyl`` on the card.  The
    iteration starts from ``u0 = (u_re, u_im)`` ``[B, n, n]`` (tensors or
    numpy arrays, e.g. the reference's ``jax.random`` draw), else from a
    standard normal draw on ``generator`` (``utils.draws``).  Empty or
    full selections report ``s = 1`` and ``sep = gap = +inf``."""
    B, n, _ = T.shape
    dtype = torch.promote_types(T.dtype, torch.float32)
    dev = T.device
    os = schur_reorder_batched(T.to(dtype), Q.to(dtype), select)
    t_re, t_im, m = os.t_re, os.t_im, os.m
    idx = torch.arange(n, device=dev)
    sel_row = (idx[None, :] < m[:, None]).to(dtype)
    block = sel_row[:, :, None] * (1.0 - sel_row)[:, None, :]   # [B, n, n]

    def fro2(xr, xi):
        return ((xr * xr + xi * xi) * block).sum(dim=(1, 2))

    # s and ‖P‖_F from T11 X − X T22 = T12
    X_re, X_im, pert = trsyl.trsyl_masked(t_re, t_im, m, t_re * block,
                                          t_im * block)
    xf2 = fro2(X_re, X_im)
    s = 1.0 / torch.sqrt(1.0 + xf2)
    p_fro = torch.sqrt(m.to(dtype) + xf2)

    # sep by power iteration on S⁻ᴴS⁻¹ (Rayleigh quotient ‖S⁻¹u‖²)
    u_re, u_im = draws.start((B, n, n), dtype, dev, u0, generator, parts=2)
    u_re, u_im = u_re * block, u_im * block
    lam = torch.zeros(B, dtype=dtype, device=dev)
    for _ in range(sep_iters):
        nrm = torch.sqrt(torch.clamp(fro2(u_re, u_im), min=1e-30))
        u_re = u_re / nrm[:, None, None]
        u_im = u_im / nrm[:, None, None]
        v_re, v_im, _ = trsyl.trsyl_masked(t_re, t_im, m, u_re, u_im)
        lam = fro2(v_re, v_im)            # ‖S⁻¹u‖² with ‖u‖ = 1
        u_re, u_im, _ = trsyl.trsyl_masked(t_re, t_im, m, v_re, v_im,
                                           adjoint=True)
    empty = (m == 0) | (m == n)
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)
    sep = torch.where(empty, inf, 1.0 / torch.sqrt(torch.clamp(lam,
                                                               min=1e-30)))
    # the naive gap min |λ_sel − λ_unsel|
    w_re, w_im = os.w_re, os.w_im
    dr = w_re[:, :, None] - w_re[:, None, :]
    di = w_im[:, :, None] - w_im[:, None, :]
    dist = torch.sqrt(dr * dr + di * di)
    gap = torch.where(block > 0, dist, inf).amin(dim=(1, 2))
    return ClusterCondition(torch.where(empty, 1.0, s), sep, p_fro, gap, m,
                            pert & ~empty)
