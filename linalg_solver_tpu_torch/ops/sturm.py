"""Batched symmetric tridiagonal eigensolver: Sturm-count bisection, and
eigenvectors by the twisted factorization (counterpart of
``linalg_solver_tpu.ops.sturm``).

The Sturm sequence of ``T − xI``'s LDLᵀ factorization counts the
eigenvalues below x in one O(n) recurrence (dstebz's core), and all B·n
eigenvalues bisect on that count at once from the Gershgorin enclosure.
On the card the bisection is ``csrc/sturm.cu`` (``ops.kernels.sturm``:
one launch a step, a thread a (lane, index) pair, no host read inside
the loop); on the CPU its plain version.

Eigenvectors come from Fernando's twisted factorization (the MRRR
``getvec`` kernel): the LDLᵀ pivot recurrence forward and backward on
``T − λI``, the twist index where ``|s_k + p_k − a_k|`` is least, then the
vector read off the two ratio chains, with each vector's true residual
reported.  Those four scans are plain torch (Python loops of batched
operations on the tensors' device).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import sturm as _kern


def _pivmin(e: torch.Tensor, dtype) -> torch.Tensor:
    """dstebz's pivot floor ``max(eps·max|e|², tiny)`` a lane."""
    fi = torch.finfo(dtype)
    emax = (e.abs().amax(dim=1) if e.shape[1] else
            torch.zeros(e.shape[0], dtype=dtype, device=e.device))
    return torch.clamp(fi.eps * emax * emax, min=fi.tiny)


def _e2(e: torch.Tensor, dtype) -> torch.Tensor:
    """``[0, e²]``: the squared off-diagonal a pivot step reads."""
    B = e.shape[0]
    return torch.cat([torch.zeros(B, 1, dtype=dtype, device=e.device),
                      (e * e).to(dtype)], dim=1)


def sturm_count_batched(d: torch.Tensor, e: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Number of eigenvalues of the symmetric tridiagonal (diagonal ``d``
    [B, n], off-diagonal ``e`` [B, n−1]) strictly below each query point
    (``x`` [B, G]): the LDLᵀ negative-pivot count, safeguarded
    dstebz-style (pivots floored at ``pivmin``).  int32 [B, G]."""
    dtype = d.dtype
    return _kern.sturm_count(d, _e2(e, dtype), _pivmin(e, dtype),
                             x.to(dtype))


def bisect_operands(d: torch.Tensor, e: torch.Tensor):
    """The bisection's operands ``(d, e2, pivmin, a, b)``, in d's dtype
    promoted to at least float32: the diagonal, ``[0, e²]``, the pivot
    floor and each (lane, index) pair's Gershgorin enclosure ``[a, b]``
    (widened by ``2·eps·scale + tiny``)."""
    f32 = torch.promote_types(d.dtype, torch.float32)
    d = d.to(f32)
    e = e.to(f32)
    B, n = d.shape
    fi = torch.finfo(f32)
    zero = torch.zeros(B, 1, dtype=f32, device=d.device)
    epad = torch.cat([zero, e.abs(), zero], dim=1)
    r = epad[:, :-1] + epad[:, 1:]
    lo = (d - r).amin(dim=1, keepdim=True)
    hi = (d + r).amax(dim=1, keepdim=True)
    scale = torch.maximum(lo.abs(), hi.abs())
    lo = lo - 2 * fi.eps * scale - fi.tiny
    hi = hi + 2 * fi.eps * scale + fi.tiny
    return (d, _e2(e, f32), _pivmin(e, f32), lo.expand(B, n).contiguous(),
            hi.expand(B, n).contiguous())


class TridiagEigResult(NamedTuple):
    w: torch.Tensor          # [B, n] ascending eigenvalues
    converged: torch.Tensor  # [B] every interval below the resolution


def eigh_tridiagonal_batched(d: torch.Tensor, e: torch.Tensor
                             ) -> TridiagEigResult:
    """All eigenvalues of a batch of symmetric tridiagonals by Sturm
    bisection from the Gershgorin enclosure, every (lane, index) pair in
    parallel, for at most 64 steps (the stop is global over the batch,
    as the reference's loop)."""
    d, e2, pivmin, a0, b0 = bisect_operands(d, e)
    a, b, steps = _kern.bisect(d, e2, pivmin, a0, b0)
    w = 0.5 * (a + b)
    tol = 4 * torch.finfo(w.dtype).eps * torch.clamp(w.abs(), min=1.0)
    conv = ((b - a) <= tol + 1e-30).all(dim=1) | (steps < _kern.STEPS)
    return TridiagEigResult(w, conv)


class TridiagEigVecResult(NamedTuple):
    V: torch.Tensor      # [B, n, n]: column j pairs with w[:, j]
    resid: torch.Tensor  # [B, n] true ‖T v − w v‖ / ‖T‖ a vector
    ok: torch.Tensor     # [B, n] resid at the f32 floor and finite chains


def tridiag_eigenvectors_batched(d: torch.Tensor, e: torch.Tensor,
                                 w: torch.Tensor) -> TridiagEigVecResult:
    """Eigenvectors for precomputed tridiagonal eigenvalues ``w`` by the
    twisted factorization: forward pivots ``s``, backward pivots ``p``,
    the twist k minimizing ``|s_k + p_k − a_k|``, then the two ratio
    chains ``v_i = −(b_i/s_i)·v_{i+1}`` (i < k) and
    ``v_{i+1} = −(b_i/p_{i+1})·v_i`` (i ≥ k); no linear solves.  Close
    eigenvalues may give near-parallel columns with small residuals (the
    limit of any single-shift vector method)."""
    f32 = torch.promote_types(d.dtype, torch.float32)
    d, e, w = d.to(f32), e.to(f32), w.to(f32)
    B, n = d.shape
    eps = torch.finfo(f32).eps
    dev = d.device
    if n == 1:
        resid = (d - w).abs() / torch.clamp(d.abs(), min=1e-30)
        return TridiagEigVecResult(torch.ones(B, 1, 1, dtype=f32,
                                              device=dev),
                                   resid, resid <= 100 * eps)
    tnorm = d.abs().amax(dim=1) + 2 * e.abs().amax(dim=1)        # [B]
    BN = B * n
    a = (d[:, None, :] - w[:, :, None]).reshape(BN, n)         # d − λ
    bb = e[:, None, :].expand(B, n, n - 1).reshape(BN, n - 1)
    b2 = bb * bb
    pivmin = (eps * eps * torch.clamp(tnorm, min=1e-30) ** 2
              )[:, None].expand(B, n).reshape(BN)

    def guard(q, pm):
        return torch.where(q.abs() < pm, -pm, q)

    # forward pivots s_i = a_i − b_{i−1}²/s_{i−1}
    s = torch.empty(BN, n, dtype=f32, device=dev)
    prev = torch.ones(BN, dtype=f32, device=dev)
    for i in range(n):
        b2i = b2[:, i - 1] if i > 0 else torch.zeros_like(prev)
        prev = a[:, i] - b2i / guard(prev, pivmin)
        s[:, i] = prev
    # backward pivots p_i = a_i − b_i²/p_{i+1}
    p = torch.empty(BN, n, dtype=f32, device=dev)
    nxt = torch.ones(BN, dtype=f32, device=dev)
    for i in range(n - 1, -1, -1):
        b2i = b2[:, i] if i < n - 1 else torch.zeros_like(nxt)
        nxt = a[:, i] - b2i / guard(nxt, pivmin)
        p[:, i] = nxt

    gamma = s + p - a
    k = gamma.abs().argmin(dim=1)                              # [BN]
    ratio_f = -bb / guard(s[:, :-1], pivmin[:, None])  # v_i = rf[i] v_{i+1}
    ratio_b = -bb / guard(p[:, 1:], pivmin[:, None])   # v_{i+1} = rb[i] v_i

    one = torch.ones(BN, dtype=f32, device=dev)
    zero = torch.zeros(BN, dtype=f32, device=dev)
    # downward chain (i < k), seeded 1 at i = k
    u = torch.empty(BN, n, dtype=f32, device=dev)
    nxt = zero
    for i in range(n - 1, -1, -1):
        rf = ratio_f[:, i] if i < n - 1 else zero
        nxt = torch.where(k == i, one, torch.where(i < k, rf * nxt, zero))
        u[:, i] = nxt
    # upward chain (i > k), seeded 1 at i = k
    l = torch.empty(BN, n, dtype=f32, device=dev)
    prev = zero
    for i in range(n):
        rb = ratio_b[:, i - 1] if i > 0 else zero
        prev = torch.where(k == i, one, torch.where(i > k, rb * prev, zero))
        l[:, i] = prev

    onehot = (torch.arange(n, device=dev)[None, :] == k[:, None]).to(f32)
    v = u + l - onehot
    nrm = torch.sqrt((v * v).sum(dim=1))
    v = v / torch.clamp(nrm, min=1e-30)[:, None]
    finite = torch.isfinite(v).all(dim=1)
    v = torch.where(finite[:, None], v, onehot)

    V = v.reshape(B, n, n).transpose(1, 2)                    # columns
    # the true residual T v − w v through the tridiagonal product
    zrow = torch.zeros(B, 1, n, dtype=f32, device=dev)
    up = torch.cat([V[:, 1:, :] * e[:, :, None], zrow], dim=1)
    lo = torch.cat([zrow, V[:, :-1, :] * e[:, :, None]], dim=1)
    r = V * d[:, :, None] + up + lo - V * w[:, None, :]
    resid = torch.sqrt((r * r).sum(dim=1)) / torch.clamp(
        tnorm, min=1e-30)[:, None]
    ok = finite.reshape(B, n) & (resid <= 100 * n * eps)
    return TridiagEigVecResult(V, resid, ok)
