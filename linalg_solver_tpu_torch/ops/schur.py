"""Batched real Schur form: Hessenberg reduction + multishift Francis QR
(counterpart of ``linalg_solver_tpu.ops.schur``).

- ``balance_batched``: Osborne/gebal power-of-two diagonal similarity.
- ``hessenberg``: n − 2 Householder similarity steps.
- ``real_schur``: implicit Francis double-shift QR with bulge chasing on
  the Hessenberg form, batched in lockstep: every matrix carries its own
  window ``[lo, hi]``, shifts and deflation state; the chase position is
  shared and each lane's activity is masked.  One bulge per unreduced
  diagonal block, plus a chain of bulges in the bottom block
  (small-bulge multishift, LAPACK dlaqr5's shape) and aggressive early
  deflation (dlaqr2/3) above n = 96.
- ``eigvals_schur``: eigenvalues from the quasi-triangular result.
- ``real_schur_vectors`` / ``eig_real_batched``: the Schur vectors and
  strevc-style back-substitution for the eigenvectors of the real part
  of the spectrum.
- ``eig_batched``: the full eigendecomposition, complex eigenvectors as
  (re, im) pairs, cleaned by Rayleigh-shifted inverse iteration
  (``_shifted_backsolve``, a Python row loop where the reference scans
  the rows on the device).
- ``eig_condition_batched``: eigenvalues with their reciprocal condition
  numbers ``|yᴴx|``, the left eigenvectors through ``J Tᵀ J``.

The reference's device loops (``while_loop``, ``scan``, ``fori_loop``,
``cond``) are Python loops of batched operations here, but for two, each
one launch of a hand-written kernel: the bulge chase of a sweep
(``kernels.schur_chase``: its plain version chases on strided views of
the state, the chase position being a Python integer) and an AED
window's whole inner real Schur form (``kernels.schur_window``: its plain
version is ``_window_schur``).  No loop inside an outer sweep reads the
device: a loop that the reference ends early when
every lane has deflated runs to its bound instead, and a pass in which
no lane is live leaves the state as it was (``torch.where`` on a device
flag), so the result is the early stop's.  The host reads once a
``chunk`` of sweeps.  On a CUDA device one outer sweep is captured once
per shape in a CUDA graph and replayed.

Every product runs in full float32 (``f32_matmuls``), as the reference
pins ``Precision.HIGHEST``.  A Householder ``|v|²`` that is subnormal
counts as zero, as in the reference, whose arithmetic flushes
subnormals: ``2/|v|²`` would overflow.  float64 runs end to end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.precision import f32_matmuls
from .kernels import schur_chase, schur_window

def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.promote_types(a.dtype, torch.float32))


def _reflector_scale(vnorm2: torch.Tensor) -> torch.Tensor:
    """``2/|v|²``, zero where ``|v|²`` is zero or subnormal."""
    return torch.where(vnorm2 >= torch.finfo(vnorm2.dtype).tiny,
                       2.0 / vnorm2, 0.0)


def _householder_step(H, Q, k: int, mask):
    """One Householder similarity annihilating ``H[k+2:, k]`` within
    ``mask`` (rows taking part), applied on both sides of ``H`` and on
    the right of ``Q`` (when given)."""
    n = H.shape[-1]
    idx = torch.arange(n, device=H.device)
    xm = H[:, :, k] * mask
    xk = xm[:, k + 1]
    norm = torch.sqrt((xm * xm).sum(1))
    alpha = -torch.sign(torch.where(xk == 0, 1.0, xk)) * norm
    v = xm - alpha[:, None] * (idx == k + 1).to(H.dtype)
    beta = _reflector_scale((v * v).sum(1))[:, None, None]
    vH = (v[:, None, :] @ H)[:, 0]
    H = H - beta * v[:, :, None] * vH[:, None, :]
    Hv = (H @ v[:, :, None])[:, :, 0]
    H = H - beta * Hv[:, :, None] * v[:, None, :]
    if Q is not None:
        Qv = (Q @ v[:, :, None])[:, :, 0]
        Q = Q - beta * Qv[:, :, None] * v[:, None, :]
    return H, Q


def _hessenberg_impl(a: torch.Tensor, with_q: bool = False):
    """Hessenberg reduction; with ``with_q`` also the orthogonal ``Q``
    with ``A = Q H Qᵀ`` (else None)."""
    a = _f32(a)
    B, n, _ = a.shape
    idx = torch.arange(n, device=a.device)
    H = a
    Q = (torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
         if with_q else None)
    with f32_matmuls():
        for k in range(max(n - 2, 0)):
            H, Q = _householder_step(H, Q, k, (idx > k).to(H.dtype))
    return H, Q


def hessenberg(a: torch.Tensor) -> torch.Tensor:
    """Reduce a batched ``[B, n, n]`` real matrix to upper Hessenberg form
    by Householder similarity transforms (same eigenvalues)."""
    return _hessenberg_impl(a, with_q=False)[0]


class SchurResult(NamedTuple):
    T: torch.Tensor          # [B, n, n] quasi-upper-triangular
    converged: torch.Tensor  # [B] bool — window fully deflated
    sweeps: torch.Tensor     # [] i32 — sweeps actually executed
    # converged WITHOUT any escalated stall-breaker deflation: a lane
    # with clean=False still reports eigenvalues, but some were split
    # off by force-zeroing an above-roundoff entry and are degraded.
    clean: Optional[torch.Tensor] = None  # [B] bool


def _tridiag_parts(M: torch.Tensor):
    """``(diag, sub, sup)`` of a batched square matrix, ``sub`` and
    ``sup`` zero-padded to the diagonal's length (``sub[j] = M[j+1, j]``,
    ``sup[j] = M[j, j+1]``)."""
    diag = M.diagonal(0, 1, 2)
    sub = F.pad(M.diagonal(-1, 1, 2), (0, 1))
    sup = F.pad(M.diagonal(1, 1, 2), (0, 1))
    return diag, sub, sup


def _take1(M: torch.Tensor, i: torch.Tensor, j: torch.Tensor):
    """``M[b, i[b], j[b]]`` for batched indices (clamped)."""
    n = M.shape[-1]
    b = torch.arange(M.shape[0], device=M.device)
    return M[b, i.clamp(0, n - 1), j.clamp(0, n - 1)]


def _deflate(H, hi, stagnant, anorm, strict: bool = False):
    """Zero negligible subdiagonals; pull ``hi`` up past converged 1×1
    and 2×2 trailing blocks (four fixed-point rounds handle consecutive
    deflations).  ``H`` is the padded ``[B, n+1, n+1]``; the result is a
    new contiguous tensor.

    The criteria are the reference's (its docstring gives their
    reasons): the hard SMLNUM floor; the classical local test refined by
    Ahues–Tisseur; the backward-stable ``eps·‖A‖`` floor when the
    eigenvalue perturbation sits there too; Ahues–Tisseur under a
    ``4n·eps·‖A‖`` magnitude gate; and, after 20 deflation-free sweeps,
    the escalating perturbation-ordered stall breaker.  ``strict=True``
    (the AED inner solve) drops the two criteria that may zero an entry
    above ``eps·‖A‖``.  Returns ``(H, hi, stagnant, forced_now)``, the
    last flagging lanes where the breaker force-zeroed an entry above
    ``8·eps·‖A‖``."""
    B, npad, _ = H.shape
    n = npad - 1
    fi = torch.finfo(H.dtype)
    eps, tiny = fi.eps, fi.tiny

    d = H.diagonal(0, 1, 2)
    sub = H.diagonal(-1, 1, 2)
    sup = H.diagonal(1, 1, 2)
    h11, h22 = d[:, :-1], d[:, 1:]
    asub, asup = sub.abs(), sup.abs()
    ea = (eps * anorm)[:, None]
    tst = h11.abs() + h22.abs()
    nbr = F.pad(asub[:, :-1], (1, 0)) + F.pad(asub[:, 1:], (0, 1))
    tst = torch.where(tst <= ea, tst + nbr, tst)
    tol_local = eps * tst + tiny
    ab = torch.maximum(asub, asup)
    ba = torch.minimum(asub, asup)
    gap = (h11 - h22).abs()
    aa = torch.maximum(h22.abs(), gap)
    bb = torch.minimum(h22.abs(), gap)
    s_at = (aa + ab).clamp(min=tiny)
    small_at = ba * (ab / s_at) <= (eps * (bb * (aa / s_at))).clamp(
        min=tiny / eps)
    prod = asub * asup
    pert = prod / torch.maximum(gap, torch.sqrt(prod) + tiny)
    escal = torch.exp2(((stagnant.to(H.dtype) - 20.0) / 5.0).clamp(0.0, 30.0))
    stalled = stagnant >= 20
    if strict:
        small_at = torch.zeros_like(small_at)
        stalled = torch.zeros_like(stalled)
    base_small = (
        (asub <= tiny / eps)
        | ((asub <= tol_local) & small_at)
        | ((asub <= ea) & (pert <= ea))
        | (small_at & (asub <= (4.0 * n) * ea))
    )
    ee = (eps * anorm * escal)[:, None]
    stall_small = stalled[:, None] & (asub <= ee) & (pert <= ee)
    small = base_small | stall_small
    forced_now = (stall_small & ~base_small & (asub > 8.0 * ea)).any(1)
    H = H.clone(memory_format=torch.contiguous_format)
    H.diagonal(-1, 1, 2).masked_fill_(small, 0.0)

    moved = torch.zeros_like(hi, dtype=torch.bool)
    for _ in range(4):
        s_hi = _take1(H, hi, hi - 1)             # H[hi, hi-1]
        s_hi1 = _take1(H, hi - 1, hi - 2)        # H[hi-1, hi-2]
        d1 = (hi > 0) & (s_hi == 0)
        d2 = ~d1 & (hi > 1) & (s_hi1 == 0)
        d2_edge = ~d1 & (hi == 1)                # 2×2 block at the top
        hi_new = torch.where(d1, hi - 1,
                             torch.where(d2 | d2_edge, hi - 2, hi))
        moved = moved | (hi_new != hi)
        hi = hi_new.clamp(min=-1)
    stagnant = torch.where(moved, 0, stagnant + 1)
    return H, hi, stagnant, forced_now


def _block_bounds(H, hi):
    """Per-position unreduced-block bounds from the subdiagonal zero
    pattern: ``start[k]``/``end[k]`` delimit the block containing row k
    (capped at the window ``hi``) — what lets one chase run a bulge in
    every block at once."""
    B, npad, _ = H.shape
    idx = torch.arange(npad, device=H.device)
    z = H.diagonal(-1, 1, 2) == 0          # boundary between rows j, j+1
    run = torch.where(z, idx[:-1] + 1, 0)
    start = F.pad(run.cummax(1).values, (1, 0))
    cand = torch.where(z, idx[:-1], npad)
    emin = cand.flip(1).cummin(1).values.flip(1)
    end = F.pad(emin, (0, 1), value=npad)
    end = torch.minimum(end, hi[:, None])
    start = torch.minimum(start, end.clamp(min=0))
    return start, end


def _shifts_per_block(H, end, hi, stagnant):
    """Double shift (sum s, product p) per position, from the trailing
    2×2 of each position's block; dlahqr's exceptional shift after every
    10 stagnant sweeps (bottom block only)."""
    npad = H.shape[1]
    diag, sub, sup = _tridiag_parts(H)
    e = end.clamp(1, npad - 1)
    h00 = diag.gather(1, e - 1)
    h01 = sup.gather(1, e - 1)
    h10 = sub.gather(1, e - 1)
    h11 = diag.gather(1, e)
    s = h00 + h11
    p = h00 * h11 - h01 * h10
    exc = (((stagnant > 0) & (stagnant % 10 == 0))[:, None]
           & (end == hi[:, None]))
    t_exc = h10.abs() + sub.gather(1, (e - 2).clamp(min=0)).abs()
    d_exc = 0.75 * t_exc + h11
    s = torch.where(exc, 2.0 * d_exc, s)
    p = torch.where(exc, d_exc * d_exc + 0.4375 * t_exc * t_exc, p)
    return s, p


def _bulge_starts(H, start, end, s_arr, p_arr):
    """Deepest safe bulge start per position (dlahqr's two consecutive
    small subdiagonals test), constant over each block."""
    npad = H.shape[1]
    eps = torch.finfo(H.dtype).eps
    idx = torch.arange(npad, device=H.device)
    diag, sub, sup = _tridiag_parts(H)
    a00, a10, a01 = diag, sub, sup
    a11 = F.pad(diag[:, 1:], (0, 1))
    a21 = F.pad(sub[:, 1:], (0, 1))
    x = a00 * a00 + a01 * a10 - s_arr * a00 + p_arr
    y = a10 * (a00 + a11 - s_arr)
    z = a10 * a21
    sub_m1 = F.pad(sub[:, :-1], (1, 0))                  # H[l, l−1]
    diag_m1 = F.pad(diag[:, :-1], (1, 0))
    ok = (sub_m1.abs() * (y.abs() + z.abs())
          <= eps * x.abs() * (diag_m1.abs() + a00.abs() + a11.abs()))
    valid = ok & (idx >= start + 1) & (idx <= end - 2)
    runmax = torch.where(valid, idx, 0).cummax(1).values
    blockmax = runmax.gather(1, (end - 2).clamp(0, npad - 1))
    return torch.maximum(start, blockmax)


def _window(M, ws, w: int):
    """``M[b, ws[b] + i, ws[b] + j]`` for ``i, j < w``."""
    B = M.shape[0]
    r = ws[:, None] + torch.arange(w, device=M.device)
    rows = M.gather(1, r[:, :, None].expand(B, w, M.shape[2]))
    return rows.gather(2, r[:, None, :].expand(B, w, w))


def _blend(live, new, old):
    """``new`` where the device flag ``live`` is set, else ``old``."""
    return tuple(None if x is None else torch.where(live, x, y)
                 for x, y in zip(new, old))


def _window_shift_pairs(H, hi, start_raw, npairs: int):
    """Shift pairs for the bottom-block chain when AED is off: Ritz
    values of the trailing ``2·npairs`` window of each lane's active
    window, from up to ``3w`` inner sweeps.  Returns ``(s, p, ok)
    [B, npairs]``, slot 0 bottom-most; a slot is ``ok`` only inside the
    lane's bottom unreduced block."""
    B, npad, _ = H.shape
    n = npad - 1
    w = 2 * npairs
    ws = (hi - w + 1).clamp(0, max(n - w, 0))
    Hw = F.pad(_window(H[:, :n, :n], ws, w), (0, 1, 0, 1))
    hw = (hi - ws).clamp(-1, w - 1)
    anorm_w = Hw.abs().sum(2).amax(1)
    stag = torch.zeros_like(hi)
    for _ in range(3 * w):
        live = (hw >= 1).any()
        Hn, hn, sn, _, _ = _one_sweep(Hw, hw, stag, anorm_w)
        Hw, hw, stag = _blend(live, (Hn, hn, sn), (Hw, hw, stag))
    re, im = _eigvals_from_T(Hw[:, :w, :w])
    bs = start_raw.gather(1, hi.clamp(0, npad - 1)[:, None])[:, 0]
    pos = torch.arange(w, device=H.device)
    valid = (pos >= (bs - ws)[:, None]) & (pos <= (hi - ws)[:, None])
    return _assemble_shift_slots(re, im, valid, hi - bs + 1, npairs, H.dtype)


def _assemble_shift_slots(re, im, valid, blk, npairs: int, dtype):
    """Pair a bottom-ordered ``[B, 2·npairs]`` eigenvalue list into
    double-shift slots ``(s, p, ok)``, slot 0 bottom-most, after
    dlaqr0's shuffle (a lone real between conjugate pairs rotates past
    the pair below it, so no slot mixes a real and a complex shift)."""
    w = 2 * npairs
    for I in range(w - 1, 1, -2):
        mis = im[:, I] != -im[:, I - 1]

        def rot3(v, mis=mis, I=I):
            a, b, c = v[:, I], v[:, I - 1], v[:, I - 2]
            v = v.clone()
            v[:, I] = torch.where(mis, b, a)
            v[:, I - 1] = torch.where(mis, c, b)
            v[:, I - 2] = torch.where(mis, a, c)
            return v

        re, im, valid = rot3(re), rot3(im), rot3(valid)

    s_slots, p_slots, ok_slots = [], [], []
    for i in range(npairs):
        a, b = w - 1 - 2 * i, w - 2 - 2 * i
        ra, ia, rb, ib = re[:, a], im[:, a], re[:, b], im[:, b]
        s_slots.append(ra + rb)
        p_slots.append(ra * rb - ia * ib)
        # dead where the shuffle could not align the slot, and where the
        # shifts would be all of the block's eigenvalues
        ok_slots.append(valid[:, a] & valid[:, b] & (ia == -ib)
                        & (blk >= 4 * (i + 1)))
    return (torch.stack(s_slots, 1).to(dtype),
            torch.stack(p_slots, 1).to(dtype), torch.stack(ok_slots, 1))


def _aed(H, Q, hi, stagnant, anorm, w: int, npairs: int, with_q: bool):
    """Aggressive early deflation (LAPACK dlaqr2/3): the real Schur form
    of each lane's trailing ``w×w`` window with ``Q_w`` (up to ``2w``
    strict inner sweeps), the spike ``β·Q_w[0, :]``, the trailing run of
    window eigenvalues whose spike entries are negligible deflated, the
    surviving spike collapsed by one Householder reflector, the
    undeflated part returned to Hessenberg form, and the window written
    back with the spike column set exactly.

    Returns ``(H, Q, hi, stagnant, (sr, si, svalid), skip)``: the bottom
    ``2·npairs`` undeflated window eigenvalues (the sweep's shifts) and
    the lanes whose deflation passes dlaqr0's NIBBLE rule (≥ 14 % of the
    window), which sit this round's sweep out."""
    B, npad, _ = H.shape
    n = npad - 1
    dtype, dev = H.dtype, H.device
    idxw = torch.arange(w, device=dev)

    ws = (hi - (w - 1)).clamp(0, max(n - w, 0))
    hi_w0 = hi - ws                                     # local bottom
    beta = torch.where(ws > 0, _take1(H, ws, ws - 1), 0.0)

    # --- inner real Schur of the window, with Q accumulation, and the
    # trailing deflation run: one kernel launch where it takes the window,
    # else a chase launch a sweep ---
    Hw = F.pad(_window(H[:, :n, :n], ws, w), (0, 1, 0, 1))
    Qw = F.pad(torch.eye(w, dtype=dtype, device=dev).expand(B, w, w),
               (0, 1))
    anorm_w = Hw.abs().sum(2).amax(1)
    hw = hi_w0.clamp(-1, w - 1)
    if H.is_cuda and not schur_window.fits(w, dtype):
        Hw, Qw, hw, nd, p_fin = _window_schur(
            Hw, Qw, hw, anorm_w, beta, hi_w0, n,
            chase=schur_chase.francis_chase)
    else:
        Hw, Qw, hw, nd, p_fin = schur_window.window_schur(
            Hw, Qw, hw, anorm_w, beta, hi_w0, n)
    Tw = Hw[:, :w, :w]
    Qw = Qw[:, :, :w]
    conv_all = hw < 1
    lam_re, lam_im = _eigvals_from_T(Tw)
    s_spike = beta[:, None] * Qw[:, 0, :]               # [B, w]

    # --- shift harvest (before the collapse scrambles the blocks) ---
    m = 2 * npairs
    sl_idx = p_fin[:, None] - (m - 1) + torch.arange(m, device=dev)
    sl_ok = (sl_idx >= 0) & (sl_idx <= p_fin[:, None])
    sl_ok = sl_ok & (conv_all[:, None] | (sl_idx > hw[:, None]))
    cl = sl_idx.clamp(0, w - 1)
    sr, si = lam_re.gather(1, cl), lam_im.gather(1, cl)

    with f32_matmuls():
        # --- collapse the surviving spike: one Householder on 0..p_fin
        u = s_spike * (idxw <= p_fin[:, None]).to(dtype)
        unorm = torch.sqrt((u * u).sum(1))
        u0 = u[:, 0]
        alpha = -torch.sign(torch.where(u0 == 0, 1.0, u0)) * unorm
        v = u - alpha[:, None] * (idxw == 0).to(dtype)
        tau = _reflector_scale((v * v).sum(1))[:, None, None]
        vT = (v[:, None, :] @ Tw)[:, 0]
        Tw = Tw - tau * v[:, :, None] * vT[:, None, :]
        Tv = (Tw @ v[:, :, None])[:, :, 0]
        Tw = Tw - tau * Tv[:, :, None] * v[:, None, :]
        Qv = (Qw @ v[:, :, None])[:, :, 0]
        Qw = Qw - tau * Qv[:, :, None] * v[:, None, :]
        sigma = torch.where(beta != 0, alpha, 0.0)

        # --- the undeflated part (rows 0..p_fin) back to Hessenberg ---
        for k in range(max(w - 2, 0)):
            mask = ((idxw > k) & (idxw <= p_fin[:, None])).to(dtype)
            Tw, Qw = _householder_step(Tw, Qw, k, mask)
        Tw = torch.where(torch.ones(w, w, dtype=torch.bool, device=dev)
                         .tril(-2), 0.0, Tw)

        # --- write back: similarity by the embedded Qw, the window block
        # and the collapsed spike column set exactly ---
        cols = ws[:, None] + idxw                      # [B, w]
        ci = cols[:, None, :].expand(B, npad, w)
        H = H.scatter(2, ci, H.gather(2, ci) @ Qw)
        ri = cols[:, :, None].expand(B, w, npad)
        R = Qw.transpose(1, 2) @ H.gather(1, ri)
        R = R.scatter(2, cols[:, None, :].expand(B, w, w), Tw)
        H = H.scatter(1, ri, R)
        ii = torch.arange(npad, device=dev)[None, :, None]
        jj = torch.arange(npad, device=dev)[None, None, :]
        wb = ws[:, None, None]
        colmask = (jj == wb - 1) & (ii >= wb) & (wb > 0)
        H = torch.where(colmask, torch.where(ii == wb, sigma[:, None, None],
                                             0.0), H)
        if with_q:
            qi = cols[:, None, :].expand(B, Q.shape[1], w)
            Q = Q.scatter(2, qi, Q.gather(2, qi) @ Qw)

    win_sz = (hi_w0 + 1).clamp(min=1)
    hi = hi - nd
    stagnant = torch.where(nd > 0, 0, stagnant)
    skip = (hi < 1) | (nd * 100 >= 14 * win_sz)
    return H, Q, hi, stagnant, (sr, si, sl_ok), skip


def _window_schur(Hw, Qw, hw, anorm_w, beta, hi_w0, n: int, chase=None):
    """The inner real Schur form of AED windows and their trailing
    deflation run (the plain version of ``kernels.schur_window``): up to
    ``2w`` strict sweeps of the padded windows ``Hw [B, w+1, w+1]`` with
    ``Qw [B, w, w+1]`` accumulated, a sweep in which no lane has ``hw >=
    1`` leaving the state as it was (the reference's ``while_loop`` stops
    there); then ``_trailing_deflation`` from ``hi_w0`` with the spike
    ``beta·Qw[0, :]`` (``n``: the full matrix's size).  ``chase`` runs
    each sweep's bulge chase (default: the plain chase).  Returns ``(Hw,
    Qw, hw, nd, p_fin)``."""
    chase = chase or schur_chase.francis_chase_reference
    w = Qw.shape[1]
    stg = torch.zeros_like(hw)
    for _ in range(2 * w):
        live = (hw >= 1).any()
        new = _one_sweep(Hw, hw, stg, anorm_w, Qw, strict_deflate=True,
                         chase=chase)
        Hw, hw, stg, Qw = _blend(live, new[:4], (Hw, hw, stg, Qw))
    nd, p_fin = _trailing_deflation(Hw[:, :w, :w], Qw[:, :, :w], hw, beta,
                                    hi_w0, n)
    return Hw, Qw, hw, nd, p_fin


def _trailing_deflation(Tw, Qw, hw, beta, p, n: int):
    """dlaqr3's deflation test on the window's real Schur form ``Tw``
    (no reordering): from the window's bottom row ``p`` up, the longest
    run of 1×1 and 2×2 blocks whose spike entries ``beta·Qw[0, :]`` are
    negligible, each block read as eigenvalues only where the inner
    iteration converged it (``hw``).  Returns ``(nd, p_fin)``: the rows
    deflated and the bottom row of what is left."""
    B, w, _ = Tw.shape
    fi = torch.finfo(Tw.dtype)
    eps = fi.eps
    smlnum = fi.tiny * (n / eps)
    diag_w, sub_w, sup_w = _tridiag_parts(Tw)
    s_spike = beta[:, None] * Qw[:, 0, :]               # [B, w]
    conv_all = hw < 1

    def take_w(v, i):
        return v.gather(1, i.clamp(0, w - 1)[:, None])[:, 0]

    nd = torch.zeros_like(hw)
    stop = torch.zeros_like(hw, dtype=torch.bool)
    for _ in range(w):
        is2 = (p >= 1) & (take_w(sub_w, p - 1) != 0)
        bstart = p - is2.long()
        foo = take_w(diag_w, p).abs()
        foo = torch.where(is2, foo + torch.sqrt(take_w(sub_w, p - 1).abs())
                          * torch.sqrt(take_w(sup_w, p - 1).abs()), foo)
        sv = take_w(s_spike, p).abs()
        sv = torch.where(is2, torch.maximum(sv, take_w(s_spike, p - 1).abs()),
                         sv)
        # only blocks the inner iteration converged read as eigenvalues
        conv_ok = conv_all | (bstart > hw)
        defl = (~stop & (p >= 0) & conv_ok
                & (sv <= (eps * foo).clamp(min=smlnum)))
        sz = torch.where(is2, 2, 1)
        nd = nd + torch.where(defl, sz, 0)
        p = p - torch.where(defl, sz, 0)
        stop = stop | ~defl
    return nd, p


def _one_sweep(H, hi, stagnant, anorm, Q=None, npairs: int = 1,
               shift_slots=None, skip=None, strict_deflate: bool = False,
               chase=None):
    """Deflate, pick per-block shifts, run one multibulge Francis sweep
    (one bulge per unreduced block, all chased together).  With
    ``npairs > 1`` the bottom block also chases a chain of ``npairs − 1``
    bulges spaced 3 apart, on shifts from the trailing window's Ritz
    values (``shift_slots`` from AED, else ``_window_shift_pairs``).  With
    ``Q`` (``[B, rows, npad]``) every reflector is also applied on the
    right of Q.  ``chase`` runs the bulge chase (default:
    ``schur_chase.francis_chase``).  The inputs are left as they were.
    Returns ``(H, hi, stagnant, Q, forced)``."""
    B, npad, _ = H.shape
    n = npad - 1
    H, hi, stagnant, forced = _deflate(H, hi, stagnant, anorm,
                                       strict=strict_deflate)
    start_raw, end = _block_bounds(H, hi)
    s_arr, p_arr = _shifts_per_block(H, end, hi, stagnant)

    n_chain = max(npairs - 1, 0)
    chain = None
    if npairs > 1 or shift_slots is not None:
        if shift_slots is not None:
            sr, si, sl_ok = shift_slots
            bs_h = start_raw.gather(1, hi.clamp(0, npad - 1)[:, None])[:, 0]
            s_ch, p_ch, ok_ch = _assemble_shift_slots(
                sr, si, sl_ok, hi - bs_h + 1, max(npairs, 1), H.dtype)
        else:
            s_ch, p_ch, ok_ch = _window_shift_pairs(H, hi, start_raw, npairs)
        if skip is not None:
            ok_ch = ok_ch & ~skip[:, None]
        # an exceptional-shift sweep lets the exceptional shift act alone
        exc = (stagnant > 0) & (stagnant % 10 == 0)
        ok_ch = ok_ch & ~exc[:, None]
        # bulge 0 of the bottom block takes the window's bottom pair
        use0 = (end == hi[:, None]) & ok_ch[:, :1]
        s_arr = torch.where(use0, s_ch[:, :1], s_arr)
        p_arr = torch.where(use0, p_ch[:, :1], p_arr)
        start = _bulge_starts(H, start_raw, end, s_arr, p_arr)
        if npairs > 1:
            # deepened starts per chain slot, non-increasing in bulge
            # order; a violating slot falls back to the raw block start
            hi_clip = hi.clamp(0, npad - 1)[:, None]
            bs_raw = start_raw.gather(1, hi_clip)[:, 0]
            lo_prev = start.gather(1, hi_clip)[:, 0]
            lo_list = []
            for i in range(1, npairs):
                st_i = _bulge_starts(H, start_raw, end,
                                     s_ch[:, i:i + 1].expand(B, npad),
                                     p_ch[:, i:i + 1].expand(B, npad))
                lo_i = st_i.gather(1, hi_clip)[:, 0]
                lo_i = torch.where(lo_i <= lo_prev, lo_i, bs_raw)
                lo_prev = torch.minimum(lo_prev, lo_i)
                lo_list.append(lo_i)
            chain = (torch.stack(lo_list, 1), s_ch[:, 1:], p_ch[:, 1:],
                     ok_ch[:, 1:])
    else:
        start = _bulge_starts(H, start_raw, end, s_arr, p_arr)
    if skip is not None:
        # NIBBLE-skipped lanes sit the sweep out
        end = torch.where(skip[:, None], -1, end)

    tables = schur_chase.chase_tables(start, end, s_arr, p_arr, hi, chain,
                                      n_chain)
    H, Q = (chase or schur_chase.francis_chase)(H, Q, tables, n_chain)
    return H, hi, stagnant, Q, forced


def balance_batched(a: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Osborne/gebal-style balancing: diagonal similarity D⁻¹AD with
    power-of-two factors equalizing row/column 1-norms (exact in
    floating point; a smaller ‖A‖ shrinks every eps·‖A‖ term of the QR
    iteration)."""
    return _balance_impl(a, iters)[0]


def _balance_impl(a: torch.Tensor, iters: int = 6):
    """Balancing plus the accumulated diagonal ``f`` with ``A_balanced =
    D A D⁻¹``, ``D = diag(f)``."""
    A = _f32(a)
    B, n, _ = A.shape
    eye = torch.eye(n, dtype=torch.bool, device=A.device)
    ftot = torch.ones(B, n, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        off = torch.where(eye, 0.0, A.abs())
        r, c = off.sum(2), off.sum(1)                 # row, column sums
        safe = (r > 0) & (c > 0)
        # f = 2^round(log2(sqrt(c/r))): an exact diagonal similarity
        e = torch.round(0.5 * (torch.log2(torch.where(safe, c, 1.0))
                               - torch.log2(torch.where(safe, r, 1.0))))
        f = torch.exp2(e.clamp(-40, 40))
        # gebal's gate: scale only where r + c shrinks by >= 5 %
        improves = (r * f + c / f) < 0.95 * (r + c)
        f = torch.where(safe & improves, f, 1.0)
        A = A * (f[:, :, None] / f[:, None, :])
        ftot = ftot * f
    return A, ftot


def _schur_init(a: torch.Tensor, balance: bool = True, with_q: bool = False):
    """Balance + Hessenberg + a one-row/column zero pad (the chase's
    3-wide accesses never leave the array).  Returns ``(H, Q, hi,
    stagnant, anorm, scale)``, Q padded by one zero column (None without
    ``with_q``)."""
    a = _f32(a)
    B, n = a.shape[0], a.shape[1]
    scale = torch.ones(B, n, dtype=a.dtype, device=a.device)
    if balance:
        a, scale = _balance_impl(a)
    Hh, Qh = _hessenberg_impl(a, with_q=with_q)
    H = F.pad(Hh, (0, 1, 0, 1))
    Q = F.pad(Qh, (0, 1)) if with_q else None
    hi0 = torch.full((B,), n - 1, dtype=torch.long, device=a.device)
    anorm = H.abs().sum(2).amax(1)                       # ‖·‖_inf
    return H, Q, hi0, torch.zeros_like(hi0), anorm, scale


def _schur_sweep(state, npairs: int = 1, aed_w: int = 0):
    """One outer sweep: an AED round when ``aed_w > 0``, then one Francis
    sweep.  ``state = (H, Q, hi, stagnant, anorm, forced, sweeps)``; when
    no lane has ``hi >= 1`` the state comes back as it was (``sweeps``
    counts the sweeps that ran while some lane was live).  Reads nothing
    back to the host."""
    H, Q, hi, stagnant, anorm, forced, sweeps = state
    live = (hi >= 1).any()
    shift_slots = skip = None
    H1, Q1, hi1, stag1 = H, Q, hi, stagnant
    if aed_w > 0:
        H1, Q1, hi1, stag1, shift_slots, skip = _aed(
            H1, Q1, hi1, stag1, anorm, aed_w, npairs, Q is not None)
    H1, hi1, stag1, Q1, forced_now = _one_sweep(
        H1, hi1, stag1, anorm, Q1, npairs=npairs, shift_slots=shift_slots,
        skip=skip)
    H1, Q1, hi1, stag1, forced1 = _blend(
        live, (H1, Q1, hi1, stag1, forced | forced_now),
        (H, Q, hi, stagnant, forced))
    return H1, Q1, hi1, stag1, anorm, forced1, sweeps + live.long()


class _SweepGraph:
    """One outer sweep captured in a CUDA graph on static state buffers;
    each ``replay`` runs one sweep on them in place and adds the chase and
    window kernel launches it holds to ``schur_chase.LAUNCHES`` and
    ``schur_window.LAUNCHES`` (the capture itself launches nothing)."""

    def __init__(self, state, npairs: int, aed_w: int):
        self.state = [None if t is None else t.clone() for t in state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), f32_matmuls():
            _schur_sweep(self.state, npairs, aed_w)         # warm-up
        torch.cuda.current_stream().wait_stream(side)
        before = schur_chase.LAUNCHES, schur_window.LAUNCHES
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph), f32_matmuls():
            out = _schur_sweep(self.state, npairs, aed_w)
            for dst, src in zip(self.state, out):
                if dst is not None and src is not dst:
                    dst.copy_(src)
        self.launches = (schur_chase.LAUNCHES - before[0],
                         schur_window.LAUNCHES - before[1])
        schur_chase.LAUNCHES, schur_window.LAUNCHES = before

    def load(self, state):
        for dst, src in zip(self.state, state):
            if dst is not None:
                dst.copy_(src)

    def replay(self):
        self.graph.replay()
        schur_chase.LAUNCHES += self.launches[0]
        schur_window.LAUNCHES += self.launches[1]


#: captured sweeps by (device, shape, dtype, with Q, npairs, aed_w)
_GRAPHS: dict = {}


def _sweep_graph(state, npairs: int, aed_w: int) -> _SweepGraph:
    H, Q = state[0], state[1]
    key = (H.device, tuple(H.shape), H.dtype, Q is not None, npairs, aed_w)
    if key not in _GRAPHS:
        _GRAPHS[key] = _SweepGraph(state, npairs, aed_w)
    g = _GRAPHS[key]
    g.load(state)
    return g


def _schur_sweeps(state, chunk: int, npairs: int = 1, aed_w: int = 0):
    """``chunk`` outer sweeps (those after every lane has deflated leave
    the state unchanged); returns the new state, whose last entry counts
    the sweeps that ran."""
    if state[0].is_cuda:
        g = _sweep_graph(state, npairs, aed_w)
        for _ in range(chunk):
            g.replay()
        return tuple(None if t is None else t.clone() for t in g.state)
    with f32_matmuls():
        for _ in range(chunk):
            state = _schur_sweep(state, npairs, aed_w)
    return state


def _schur_finalize(state) -> SchurResult:
    H, Q, hi, stagnant, anorm, forced = state[:6]
    H, hi, _, forced_fin = _deflate(H, hi, stagnant, anorm)
    n = H.shape[1] - 1
    # below the first subdiagonal is mathematically zero: wipe the
    # chase's roundoff residue
    T = torch.where(torch.ones(n, n, dtype=torch.bool, device=H.device)
                    .tril(-2), 0.0, H[:, :n, :n])
    conv = hi < 1
    return SchurResult(T, conv, None, conv & ~(forced | forced_fin))


def _auto_npairs(n: int) -> int:
    """Shift pairs per sweep: the single double shift below n = 96, else
    up to 8 (the window shifts also keep Gaussian batches at n = 256
    from stalling into the stall breaker)."""
    if n < 96:
        return 1
    return max(2, min(8, n // 32))


def _auto_aed_w(n: int, npairs: int) -> int:
    """Deflation-window size: off below n = 96, else ``max(n/16,
    4·npairs)`` capped at 64."""
    if n < 96 or npairs < 1:
        return 0
    return min(max(n // 16, 4 * npairs), 64)


def _sweep_config(n: int, nshift_pairs: int = 0, aed_w: int = -1):
    """The shift pairs a sweep and the AED window (0: off) ``real_schur``
    runs at ``n`` for its ``nshift_pairs`` and ``aed_w`` arguments."""
    npairs = nshift_pairs if nshift_pairs > 0 else _auto_npairs(n)
    npairs = max(1, min(npairs, n // 8 if n >= 16 else 1))
    if aed_w < 0:
        aed_w = _auto_aed_w(n, npairs)
    if aed_w > 0:
        aed_w = max(2 * npairs, min(aed_w, max(n // 2, 2)))
    return npairs, aed_w


def _run_schur(a, max_sweeps, chunk, balance, with_q, nshift_pairs=0,
               aed_w=-1):
    B, n, _ = a.shape
    if max_sweeps == 0:
        max_sweeps = 8 * n
    npairs, aed_w = _sweep_config(n, nshift_pairs, aed_w)
    H, Q, hi, stag, anorm, scale = _schur_init(a, balance=balance,
                                               with_q=with_q)
    zero = torch.zeros((), dtype=torch.long, device=H.device)
    state = (H, Q, hi, stag, anorm, torch.zeros_like(hi, dtype=torch.bool),
             zero)
    done = 0
    while done < max_sweeps:
        state = _schur_sweeps(state[:6] + (zero,),
                              min(chunk, max_sweeps - done), npairs=npairs,
                              aed_w=aed_w)
        it = int(state[6])                 # the host's one read a chunk
        done += it
        if it < chunk or not bool((state[2] >= 1).any()):
            break
    res = _schur_finalize(state)
    Qout = state[1][:, :, :n] if with_q else None
    return res, done, Qout, scale


def _sweeps(done: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(done, dtype=torch.int32, device=like.device)


def real_schur(a: torch.Tensor, max_sweeps: int = 0, chunk: int = 64,
               balance: bool = True, nshift_pairs: int = 0,
               aed_w: int = -1) -> SchurResult:
    """Quasi-upper-triangular (real Schur) form of every matrix in
    ``[B, n, n]`` via Hessenberg + Francis QR.

    ``max_sweeps=0`` picks ``8·n``.  Sweeps run in chunks of ``chunk``
    with one host-side convergence check a chunk.  ``nshift_pairs=0``
    sizes the multishift chain (1 pair below n = 96, up to 8 from
    n = 256); ``1`` forces the single double-shift sweep.  ``aed_w=-1``
    sizes the AED window (off below n = 96), ``0`` turns AED off."""
    B, n, _ = a.shape
    if n <= 2:
        H = hessenberg(a)
        ones = torch.ones(B, dtype=torch.bool, device=a.device)
        return SchurResult(H, ones, _sweeps(0, a), ones)
    res, done, _, _ = _run_schur(a, max_sweeps, chunk, balance, False,
                                 nshift_pairs, aed_w)
    return SchurResult(res.T, res.converged, _sweeps(done, a), res.clean)


class SchurVectors(NamedTuple):
    """Full real Schur decomposition of the BALANCED matrix:
    ``D A D⁻¹ = Q T Qᵀ`` with ``D = diag(scale)``; eigenvectors of A are
    ``D⁻¹ Q y`` for eigenvectors ``y`` of T."""

    T: torch.Tensor          # [B, n, n]
    Q: torch.Tensor          # [B, n, n] orthogonal
    scale: torch.Tensor      # [B, n] balance diagonal
    converged: torch.Tensor  # [B]
    sweeps: torch.Tensor     # [] i32
    clean: Optional[torch.Tensor] = None  # [B]


def real_schur_vectors(a: torch.Tensor, max_sweeps: int = 0, chunk: int = 64,
                       balance: bool = True, nshift_pairs: int = 0,
                       aed_w: int = -1) -> SchurVectors:
    """``real_schur`` with the orthogonal similarity accumulated
    (reflectors applied on the right of Q through Hessenberg and every
    chase step)."""
    B, n, _ = a.shape
    if n <= 2:
        Hh, Qh = _hessenberg_impl(a, with_q=True)
        # a 2×2 with real eigenvalues is one unsplit block
        Hh, Qh = _standardize_real_blocks(Hh, Qh)
        ones = torch.ones(B, dtype=torch.bool, device=a.device)
        return SchurVectors(Hh, Qh, torch.ones(B, n, dtype=Hh.dtype,
                                               device=a.device),
                            ones, _sweeps(0, a), ones)
    res, done, Q, scale = _run_schur(a, max_sweeps, chunk, balance, True,
                                     nshift_pairs, aed_w)
    # real-eigenvalue 2×2 blocks deflate unsplit; eigenvectors need them
    # triangular
    T, Q = _standardize_real_blocks(res.T, Q)
    return SchurVectors(T, Q, scale, res.converged, _sweeps(done, a),
                        res.clean)


class SchurEigvals(NamedTuple):
    real: torch.Tensor       # [B, n]
    imag: torch.Tensor       # [B, n]
    converged: torch.Tensor  # [B]
    clean: Optional[torch.Tensor] = None  # [B]


def eigvals_schur(a: torch.Tensor, max_sweeps: int = 0, chunk: int = 64,
                  balance: bool = True, nshift_pairs: int = 0,
                  aed_w: int = -1) -> SchurEigvals:
    """Eigenvalues of a batched real matrix via the real Schur form:
    diagonal entries for 1×1 blocks, exact conjugate pairs from 2×2
    blocks."""
    res = real_schur(a, max_sweeps=max_sweeps, chunk=chunk, balance=balance,
                     nshift_pairs=nshift_pairs, aed_w=aed_w)
    re, im = _eigvals_from_T(res.T)
    return SchurEigvals(re, im, res.converged, res.clean)


def _eigvals_from_T(T: torch.Tensor):
    diag, sub, up = _tridiag_parts(T)
    live = sub != 0                       # [B, n]: block (i, i+1)
    nxt = torch.roll(diag, -1, 1)
    tr2 = diag + nxt
    # ((h11−h22)/2)² + h12·h21, without (tr/2)² − det's cancellation
    disc2 = ((diag - nxt) / 2) ** 2 + up * sub
    re_pair = tr2 / 2
    im_pair = torch.sqrt((-disc2).clamp(min=0))
    sq = torch.sqrt(disc2.clamp(min=0))
    is_second = F.pad(live[:, :-1], (1, 0))
    is_first = live & ~is_second
    disc_prev = torch.roll(disc2, 1, 1)
    real = torch.where(is_first, re_pair, diag)
    real = torch.where(is_second, torch.roll(re_pair, 1, 1), real)
    real = torch.where(is_first & (disc2 >= 0), re_pair + sq, real)
    real = torch.where(is_second & (disc_prev >= 0),
                       torch.roll(re_pair - sq, 1, 1), real)
    imag = torch.where(is_first & (disc2 < 0), im_pair, 0.0)
    imag = torch.where(is_second & (disc_prev < 0),
                       -torch.roll(im_pair, 1, 1), imag)
    return real, imag


def _trevc_full(T: torch.Tensor):
    """Eigenvectors of a quasi-upper-triangular ``T`` for the full
    spectrum by back-substitution in re/im arithmetic (LAPACK strevc):
    ``(T − λᵢ I) y = 0`` solved rows bottom-up, 2×2 diagonal blocks
    jointly (Cramer), small denominators replaced by ``±smin = eps·‖T‖``.
    A complex pair's first column carries the eigenvector of ``m + b·i``
    (b > 0), the second its conjugate.  All n columns at once, one row a
    step.  Returns ``(Y_re, Y_im [B, n, n], valid [B, n])``; columns of
    improper structure are zeroed and flagged invalid."""
    B, n, _ = T.shape
    dtype = T.dtype
    eps = torch.finfo(dtype).eps
    idx = torch.arange(n, device=T.device)

    diag, sub, sup = _tridiag_parts(T)
    sub_prev = F.pad(sub[:, :-1], (1, 0))
    sub_next = F.pad(sub[:, 1:], (0, 1))
    lam_re, lam_im = _eigvals_from_T(T)
    cfirst = lam_im > 0                         # top column of a pair
    csecond = lam_im < 0
    valid_real = (lam_im == 0) & (sub == 0) & (sub_prev == 0)
    valid_first = cfirst & (sub != 0) & (sub_prev == 0) & (sub_next == 0)
    valid_second = F.pad(valid_first[:, :-1], (1, 0)) & csecond
    valid = valid_real | valid_first | valid_second
    smin = eps * T.abs().amax((1, 2))                       # [B]

    # identity columns for 1×1 blocks; for a pair's first column p the
    # in-block eigenvector [t12, (m − t11) + b·i] at rows (p, p+1)
    eyeM = torch.eye(n, dtype=dtype, device=T.device)
    submask = (idx[:, None] == idx[None, :] + 1).to(dtype)
    cf = cfirst.to(dtype)
    diag_vals = torch.where(cfirst, sup, 1.0)
    Y_re = (eyeM * diag_vals[:, None, :]
            + submask * (cf * (lam_re - diag))[:, None, :])
    Y_im = submask * (cf * lam_im)[:, None, :]

    sm = smin[:, None]
    with f32_matmuls():
        for j in range(n - 2, -1, -1):
            is_top = sub[:, j] != 0
            is_bottom = (sub[:, j - 1] != 0 if j >= 1
                         else torch.zeros_like(is_top))
            jp1 = min(j + 1, n - 1)
            trow_j, trow_j1 = T[:, j, :], T[:, jp1, :]
            # residuals against the rows right of the block
            tj = (trow_j * (idx > j))[:, None, :]
            tj1 = (trow_j1 * (idx > jp1))[:, None, :]
            r1_re, r1_im = (tj @ Y_re)[:, 0], (tj @ Y_im)[:, 0]
            r2_re, r2_im = (tj1 @ Y_re)[:, 0], (tj1 @ Y_im)[:, 0]

            # scalar step y = −r / (T[j,j] − λ), small d replaced by ±smin
            d_re = diag[:, j:j + 1] - lam_re
            d_im = -lam_im
            dsmall = d_re * d_re + d_im * d_im < sm * sm
            d_re = torch.where(dsmall, torch.where(d_re < 0, -sm, sm), d_re)
            d_im = torch.where(dsmall, 0.0, d_im)
            den2 = d_re * d_re + d_im * d_im
            ys_re = -(r1_re * d_re + r1_im * d_im) / den2
            ys_im = -(r1_im * d_re - r1_re * d_im) / den2

            # joint 2×2 step: [a11 a12; a21 a22][y_top; y_bot] = [−r1; −r2]
            a12 = trow_j[:, jp1:jp1 + 1]                   # T[j, j+1]
            a21 = sub[:, j:j + 1]                          # T[j+1, j]
            e_re = diag[:, jp1:jp1 + 1] - lam_re
            e_im = -lam_im
            det_re = d_re * e_re - d_im * e_im - a12 * a21
            det_im = d_re * e_im + d_im * e_re
            cmax = torch.maximum(
                torch.maximum(d_re.abs() + d_im.abs(),
                              e_re.abs() + e_im.abs()),
                torch.maximum(a12.abs(), a21.abs()))
            dfloor = sm * torch.maximum(cmax, sm)
            det_small = det_re * det_re + det_im * det_im < dfloor * dfloor
            det_re = torch.where(det_small,
                                 torch.where(det_re < 0, -dfloor, dfloor),
                                 det_re)
            det_im = torch.where(det_small, 0.0, det_im)
            det2 = det_re * det_re + det_im * det_im
            nt_re = -(r1_re * e_re - r1_im * e_im) + a12 * r2_re
            nt_im = -(r1_re * e_im + r1_im * e_re) + a12 * r2_im
            nb_re = -(r2_re * d_re - r2_im * d_im) + a21 * r1_re
            nb_im = -(r2_re * d_im + r2_im * d_re) + a21 * r1_im
            yt_re = (nt_re * det_re + nt_im * det_im) / det2
            yt_im = (nt_im * det_re - nt_re * det_im) / det2
            yb_re = (nb_re * det_re + nb_im * det_im) / det2
            yb_im = (nb_im * det_re - nb_re * det_im) / det2

            right_of = (idx > jp1) | ((idx > j) & ~is_top[:, None])
            top = right_of & ~is_bottom[:, None]
            Y_re[:, j] = torch.where(
                top, torch.where(is_top[:, None], yt_re, ys_re), Y_re[:, j])
            Y_im[:, j] = torch.where(
                top, torch.where(is_top[:, None], yt_im, ys_im), Y_im[:, j])
            bot = is_top[:, None] & (idx > jp1)
            Y_re[:, jp1] = torch.where(bot, yb_re, Y_re[:, jp1])
            Y_im[:, jp1] = torch.where(bot, yb_im, Y_im[:, jp1])
    # second pair columns = conjugate of the first
    cs = csecond[:, None, :]
    Y_re = torch.where(cs, torch.roll(Y_re, 1, 2), Y_re)
    Y_im = torch.where(cs, -torch.roll(Y_im, 1, 2), Y_im)
    Y_re = Y_re * valid[:, None, :]
    Y_im = Y_im * valid[:, None, :]
    norms = torch.sqrt((Y_re * Y_re + Y_im * Y_im).sum(1))
    norms = norms.clamp(min=1e-30)[:, None, :]
    return Y_re / norms, Y_im / norms, valid


def _trevc_real(T: torch.Tensor):
    """Real-spectrum view of ``_trevc_full``: eigenvectors for the 1×1
    real blocks only, complex-pair columns zeroed and flagged invalid."""
    Y_re, _, valid = _trevc_full(T)
    _, lam_im = _eigvals_from_T(T)
    valid_real = valid & (lam_im == 0)
    return Y_re * valid_real[:, None, :], valid_real


class EigResult(NamedTuple):
    """Eigenvalues (in Schur diagonal order, not sorted) and right
    eigenvectors for the real part of the spectrum."""

    real: torch.Tensor       # [B, n]
    imag: torch.Tensor       # [B, n]
    vectors: torch.Tensor    # [B, n, n] — column i pairs with eigenvalue i
    valid: torch.Tensor      # [B, n] — True where a real eigenvector exists
    converged: torch.Tensor  # [B]
    clean: Optional[torch.Tensor] = None  # [B]


def eig_real_batched(a: torch.Tensor, max_sweeps: int = 0, chunk: int = 64,
                     balance: bool = True, nshift_pairs: int = 0,
                     aed_w: int = -1) -> EigResult:
    """Right eigenvectors of a general real batch at O(n³) a matrix: real
    Schur with accumulated Q, then strevc-style back-substitution
    (``V = D⁻¹ Q Y`` undoes the balance).  Complex pairs get
    ``valid=False`` columns; back-substituted columns of a repeated
    eigenvalue are near-dependent (the nullspace path,
    ``ops.eigen.spectral_decompose_batched``, serves clustered
    spectra)."""
    sv = real_schur_vectors(a, max_sweeps=max_sweeps, chunk=chunk,
                            balance=balance, nshift_pairs=nshift_pairs,
                            aed_w=aed_w)
    Y, valid = _trevc_real(sv.T)
    re, im = _eigvals_from_T(sv.T)
    with f32_matmuls():
        V = sv.Q @ Y
    V = V / sv.scale[:, :, None]
    norms = torch.sqrt((V * V).sum(1))
    V = V / norms.clamp(min=1e-30)[:, None, :]
    V = V * valid[:, None, :]
    return EigResult(re, im, V, valid, sv.converged, sv.clean)


def _standardize_real_blocks(T: torch.Tensor, Q: torch.Tensor):
    """Split 2×2 diagonal blocks whose eigenvalues are real into 1×1
    blocks by one orthogonal rotation a block (dlanv2's job), all in one
    similarity (disjoint supports commute): T ← Gᵀ T G, Q ← Q G.
    Complex-pair blocks are left as they are."""
    B, n, _ = T.shape
    dtype = T.dtype
    idx = torch.arange(n, device=T.device)
    diag, sub, sup = _tridiag_parts(T)
    sub_prev = F.pad(sub[:, :-1], (1, 0))
    a, d = diag, F.pad(diag[:, 1:], (0, 1))
    half = (a - d) / 2
    disc = half * half + sup * sub
    top = (sub != 0) & (sub_prev == 0) & (disc >= 0)        # [B, n]
    s = torch.sqrt(disc.clamp(min=0.0))
    sgn = torch.where(half < 0, -1.0, 1.0)
    lam1 = (a + d) / 2 + sgn * s
    lam2 = (a + d) / 2 - sgn * s
    # eigenvector of the block for lam1: [lam1 − d, c] (c ≠ 0 on blocks)
    v0, v1 = half + sgn * s, sub
    nrm = torch.sqrt(v0 * v0 + v1 * v1)
    nrm = torch.where(nrm > 0, nrm, 1.0)
    cs, sn = v0 / nrm, v1 / nrm
    bottom = F.pad(top[:, :-1], (1, 0))
    cs_sh = F.pad(cs[:, :-1], (1, 0), value=1.0)
    dvec = torch.where(top, cs, torch.where(bottom, cs_sh, 1.0))
    eye_m = (idx[:, None] == idx[None, :]).to(dtype)
    up_m = (idx[:, None] + 1 == idx[None, :]).to(dtype)
    lo_m = (idx[:, None] == idx[None, :] + 1).to(dtype)
    snt = torch.where(top, sn, 0.0)
    G = (eye_m * dvec[:, :, None] - up_m * snt[:, :, None]
         + lo_m * snt[:, None, :])
    with f32_matmuls():
        T2 = G.transpose(1, 2) @ T @ G
        Q2 = Q @ G
    # force the exact structure on rotated blocks
    lam2_sh = F.pad(lam2[:, :-1], (1, 0))
    newdiag = torch.where(top, lam1, torch.where(bottom, lam2_sh, diag))
    T2 = torch.where(eye_m > 0, newdiag[:, :, None] * eye_m
                     + (1 - eye_m) * T2, T2)
    T2 = torch.where((lo_m * top.to(dtype)[:, None, :]) > 0, 0.0, T2)
    T2 = torch.where(torch.ones(n, n, dtype=torch.bool, device=T.device)
                     .tril(-2), 0.0, T2)
    return T2, Q2


class EigFullResult(NamedTuple):
    """Full eigendecomposition (eigenvalues in Schur diagonal order, not
    sorted): complex right eigenvectors as (re, im) pairs.  A conjugate
    pair's second column holds the conjugate eigenvector."""

    real: torch.Tensor          # [B, n]
    imag: torch.Tensor          # [B, n]
    vectors_real: torch.Tensor  # [B, n, n]
    vectors_imag: torch.Tensor  # [B, n, n]
    valid: torch.Tensor         # [B, n]
    converged: torch.Tensor     # [B]
    clean: Optional[torch.Tensor] = None  # [B] converged w/o forced deflations


def _unit_columns(V_re, V_im):
    norms = torch.sqrt((V_re * V_re + V_im * V_im).sum(1))
    norms = norms.clamp(min=1e-30)[:, None, :]
    return V_re / norms, V_im / norms


def eig_batched(a: torch.Tensor, max_sweeps: int = 0, chunk: int = 64,
                balance: bool = True, refine_steps: int = 1,
                nshift_pairs: int = 0, aed_w: int = -1) -> EigFullResult:
    """Complete right eigendecomposition of a general real batch at O(n³)
    a matrix: real Schur with accumulated Q, then the full strevc
    back-substitution in re/im arithmetic (``V = D⁻¹ Q Y`` undoes the
    balance similarity).  Complex-conjugate pairs get proper complex
    eigenvectors.  For clustered or repeated eigenvalues prefer the
    nullspace path (``ops.eigen.spectral_decompose_batched``).

    ``refine_steps`` (default 1) rounds of Rayleigh-shifted inverse
    iteration: each round re-estimates every column's eigenvalue as the
    Rayleigh quotient ``λ = vᴴAv / vᴴv`` of its current vector in the
    original basis (for a fixed v the minimizer of ‖Av − λv‖), then runs
    one ``_shifted_backsolve`` pass in the T basis at that shift.  A
    per-column accept-if-better gate on the true residual in the original
    basis makes refinement monotone: accepted columns report their
    Rayleigh eigenvalue, rejected ones keep the Schur one.
    ``refine_steps=0`` returns the raw strevc output."""
    sv = real_schur_vectors(a, max_sweeps=max_sweeps, chunk=chunk,
                            balance=balance, nshift_pairs=nshift_pairs,
                            aed_w=aed_w)
    Y_re, Y_im, valid = _trevc_full(sv.T)
    re, im = _eigvals_from_T(sv.T)

    def back(Y_re, Y_im):
        with f32_matmuls():
            V_re, V_im = sv.Q @ Y_re, sv.Q @ Y_im
        return _unit_columns(V_re / sv.scale[:, :, None],
                             V_im / sv.scale[:, :, None])

    V_re, V_im = back(Y_re, Y_im)

    if refine_steps:
        a32 = a.to(sv.T.dtype)

        def rayleigh(V_re, V_im):
            """Per-column ``λ = vᴴAv / vᴴv`` and the ``A v`` products the
            residual shares."""
            with f32_matmuls():
                Av_re, Av_im = a32 @ V_re, a32 @ V_im
            num_re = (V_re * Av_re + V_im * Av_im).sum(1)
            num_im = (V_re * Av_im - V_im * Av_re).sum(1)
            den = (V_re * V_re + V_im * V_im).sum(1).clamp(min=1e-30)
            return num_re / den, num_im / den, Av_re, Av_im

        def col_resid(Av_re, Av_im, V_re, V_im, lr, li):
            r_re = Av_re - (lr[:, None, :] * V_re - li[:, None, :] * V_im)
            r_im = Av_im - (lr[:, None, :] * V_im + li[:, None, :] * V_re)
            return torch.sqrt((r_re * r_re + r_im * r_im).sum(1))

        rq_re, rq_im, Av_re, Av_im = rayleigh(V_re, V_im)
        base = col_resid(Av_re, Av_im, V_re, V_im, re, im)
        for _ in range(refine_steps):
            Y_re, Y_im = _unit_columns(
                *_shifted_backsolve(sv.T, rq_re, rq_im, Y_re, Y_im))
            V2_re, V2_im = back(Y_re, Y_im)
            r2_re, r2_im, Av2_re, Av2_im = rayleigh(V2_re, V2_im)
            new = col_resid(Av2_re, Av2_im, V2_re, V2_im, r2_re, r2_im)
            better = new < base                       # [B, n]
            bN = better[:, None, :]
            V_re = torch.where(bN, V2_re, V_re)
            V_im = torch.where(bN, V2_im, V_im)
            re = torch.where(better, r2_re, re)
            im = torch.where(better, r2_im, im)
            base = torch.minimum(new, base)
            rq_re = torch.where(better, r2_re, rq_re)
            rq_im = torch.where(better, r2_im, rq_im)

    vmask = valid[:, None, :]
    return EigFullResult(re, im, V_re * vmask, V_im * vmask, valid,
                         sv.converged, sv.clean)


@f32_matmuls()
def _shifted_backsolve(T, lam_re, lam_im, R_re, R_im):
    """Solve ``(T − λᵢ I) wᵢ = rᵢ`` for every column i at once (T
    quasi-upper-triangular, λ complex a column, r complex): the
    inverse-iteration step (dhsein), back-substitution from the bottom
    row with safeguarded denominators and joint 2×2 block solves, O(n³)
    in all for n columns.  ``R [B, n, k]`` may have any column count k
    (n for eigenvectors, m for Sylvester right sides).

    The reference scans the rows on the device.  Here the row loop is a
    Python loop of batched operations in complex64 (complex128 for
    float64 T): everything that does not depend on the solution so far
    (the safeguarded pivots of every row and their reciprocals) is formed
    for all rows before the loop, so a row is one product with the rows
    below and about a dozen elementwise launches."""
    B, n, _ = T.shape
    k = R_re.shape[2]
    dtype = T.dtype
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    eps = torch.finfo(dtype).eps
    diag, sub, sup = _tridiag_parts(T)
    sm = (eps * T.abs().amax((1, 2)))[:, None, None]          # [B, 1, 1]
    lr, li = lam_re[:, None, :], lam_im[:, None, :]

    # every row's scalar pivot d = T[j,j] − λ, small d replaced by ±smin
    d_re = diag[:, :, None] - lr
    d_im = (-li).expand_as(d_re)
    dsmall = d_re * d_re + d_im * d_im < sm * sm
    d_re = torch.where(dsmall, torch.where(d_re < 0, -sm, sm), d_re)
    d_im = torch.where(dsmall, 0.0, d_im)
    d = torch.complex(d_re, d_im)
    d_inv = d.conj() / (d_re * d_re + d_im * d_im)
    # and its 2×2 block [d a12; a21 e] with e = T[j+1,j+1] − λ, the
    # determinant floored at smin·max(|entries|, smin)
    e_re = F.pad(diag[:, 1:], (0, 1))[:, :, None] - lr
    e_im = (-li).expand_as(e_re)
    e = torch.complex(e_re, e_im)
    a12, a21 = sup[:, :, None], sub[:, :, None]
    det_re = d_re * e_re - d_im * e_im - a12 * a21
    det_im = d_re * e_im + d_im * e_re
    cmax = torch.maximum(
        torch.maximum(d_re.abs() + d_im.abs(), e_re.abs() + e_im.abs()),
        torch.maximum(a12.abs(), a21.abs()))
    dfloor = sm * torch.maximum(cmax, sm)
    det_small = det_re * det_re + det_im * det_im < dfloor * dfloor
    det_re = torch.where(det_small,
                         torch.where(det_re < 0, -dfloor, dfloor), det_re)
    det_im = torch.where(det_small, 0.0, det_im)
    det_inv = (torch.complex(det_re, -det_im)
               / (det_re * det_re + det_im * det_im))
    a12c, a21c = a12.to(cdt), a21.to(cdt)
    is_top = (sub != 0)[:, :, None]                         # [B, n, 1]
    is_bottom = F.pad(sub[:, :-1] != 0, (1, 0))[:, :, None]

    # one zero row below the last: row n − 1's "next row" reads it
    Tu = F.pad(torch.triu(T, 1), (0, 0, 0, 1))               # [B, n+1, n]
    R = F.pad(torch.complex(R_re, R_im).to(cdt), (0, 0, 0, 1))
    W = torch.zeros(B, n + 1, k, dtype=cdt, device=T.device)
    Wr = torch.view_as_real(W).view(B, n + 1, 2 * k)
    for j in range(n - 1, -1, -1):
        # T's rows j, j+1 right of the block against the rows solved
        s = torch.view_as_complex(
            (Tu[:, j:j + 2] @ Wr[:, :n]).view(B, 2, k, 2))
        rhs = R[:, j:j + 2] - s
        r1, r2 = rhs[:, 0], rhs[:, 1]
        ws = r1 * d_inv[:, j]
        wt = (r1 * e[:, j] - a12c[:, j] * r2) * det_inv[:, j]
        wb = (r2 * d[:, j] - a21c[:, j] * r1) * det_inv[:, j]
        top = torch.where(is_top[:, j], wt, ws)
        W[:, j] = torch.where(is_bottom[:, j], W[:, j], top)
        W[:, j + 1] = torch.where(is_top[:, j], wb, W[:, j + 1])
    W = W[:, :n]
    return W.real.contiguous(), W.imag.contiguous()


class EigConditionResult(NamedTuple):
    """Per-eigenvalue reciprocal condition numbers (dtrsna RCONDE
    semantics, computed for the balanced matrix like dgeevx):
    ``s[b, i] = |yᵢᴴ xᵢ|`` for unit right/left eigenvectors; a
    first-order perturbation ``E`` moves λᵢ by at most about
    ``‖E‖₂ / s[b, i]``.  ``err_est = eps·‖A‖·(1/s)`` is the
    rule-of-thumb f32 eigenvalue error bar."""

    real: torch.Tensor       # [B, n] eigenvalues (Schur order)
    imag: torch.Tensor       # [B, n]
    s: torch.Tensor          # [B, n] reciprocal condition numbers in (0, 1]
    err_est: torch.Tensor    # [B, n] eps·‖A‖/s
    valid: torch.Tensor      # [B, n] both eigenvector solves structurally ok
    converged: torch.Tensor  # [B]


def eig_condition_batched(a: torch.Tensor, max_sweeps: int = 0,
                          chunk: int = 64, balance: bool = True,
                          nshift_pairs: int = 0,
                          aed_w: int = -1) -> EigConditionResult:
    """Eigenvalues with per-eigenvalue condition numbers.

    Right eigenvectors come from ``_trevc_full(T)``; left eigenvectors
    from the same back-substitution through the reversal ``J Tᵀ J`` (J
    the anti-diagonal permutation), which is quasi-upper-triangular with
    T's diagonal blocks in reversed order: one more ``_trevc_full`` and
    row/column reversals give every left eigenvector.  ``sᵢ = |yᵢᴴxᵢ|``
    is invariant under the orthogonal Q, so it is computed in the T basis
    (one [B, n] reduction, no n×n back-transforms).

    The Schur form and both back-substitutions run in float64, float32
    input too (the results come back in the input's precision, and
    ``err_est`` keeps its eps): an s whose eigenvalue has a close
    neighbour moves with the Schur form's rounding, and a float32 form
    left it 0.1–0.4 % off on 256×256 Gaussian lanes, by rounding path
    (the reference's on a CPU 1.3e-3, this port's on an H100 4.0e-3,
    where s ≈ 0.014 and the neighbour 0.07 away)."""
    return _eig_condition(a, torch.float64, max_sweeps=max_sweeps,
                          chunk=chunk, balance=balance,
                          nshift_pairs=nshift_pairs, aed_w=aed_w)


def _eig_condition(a: torch.Tensor, work: torch.dtype,
                   **schur_kwargs) -> EigConditionResult:
    """``eig_condition_batched`` with its Schur form and back-substitutions
    in ``work``: float64 there; float32 is the reference's arithmetic,
    which ``chip_smoke.py`` times beside it."""
    dt = _f32(a).dtype
    sv = real_schur_vectors(a.to(work), **schur_kwargs)
    T = sv.T
    Xr, Xi, valid_r = _trevc_full(T)
    S = T.transpose(1, 2).flip((1, 2))
    Zr, Zi, valid_l = _trevc_full(S)
    # the left eigenvector of T at diagonal position j is J times column
    # n−1−j of S's right eigenvectors; its eigenvalue may be the conjugate
    # (a pair's first-column convention lands on the other member after
    # the reversal): conjugate exactly where λ_S = λ, so that Tᵀ y = λ̄ y
    Yr, Yi = Zr.flip((1, 2)), Zi.flip((1, 2))
    valid_l = valid_l.flip(1)
    lam_re, lam_im = _eigvals_from_T(T)
    _, lamS_im = _eigvals_from_T(S)
    lamS_im = lamS_im.flip(1)
    conj_fix = (lamS_im - lam_im).abs() < (lamS_im + lam_im).abs()
    Yi = torch.where(conj_fix[:, None, :], -Yi, Yi)
    # s = |yᴴ x| with unit columns: yᴴx = (yr − i·yi)ᵀ(xr + i·xi)
    dot_re = (Yr * Xr + Yi * Xi).sum(1)
    dot_im = (Yr * Xi - Yi * Xr).sum(1)
    s = torch.sqrt(dot_re * dot_re + dot_im * dot_im)
    eps = torch.finfo(dt).eps
    anorm = T.abs().amax((1, 2))
    err_est = eps * anorm[:, None] / s.clamp(min=1e-30)
    return EigConditionResult(lam_re.to(dt), lam_im.to(dt), s.to(dt),
                              err_est.to(dt), valid_r & valid_l,
                              sv.converged)
