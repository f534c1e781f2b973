"""Fraction-free (Bareiss) elimination on the device: bit-exact integer
linear algebra (counterpart of ``linalg_solver_tpu.ops.exact_int``).

For integer matrices Bareiss keeps every intermediate an exact integer
(each 2×2 cross-multiplication step divides exactly by the previous
pivot), so zero tests, pivots, determinants and ranks are exact, with no
tolerance.

The working type is int32, as in the reference: exactness holds while
intermediates stay below 2³¹.  ``bareiss_batched`` checks that at run
time through a float32 mirror and reports ``ok`` per matrix, in the
same lanes as the reference (a wider type would be a feature the
reference lacks, and would change ``ok``).  Pivots follow the reference's
first-nonzero-row rule.  The check is conservative, and int32 is narrow:
on BASELINE config 1's class (8×8, entries in [-5, 5)) it flags most
matrices (``bareiss_safe(8, 5)`` is False), where ``crt_det_batched``
is exact.

Past int32, residue arithmetic: eliminate modulo 15-bit primes on the
device (residue products below 2³⁰ stay exact in int32), then
reconstruct the determinant, rank or solution on the host with Python
integers by the Chinese Remainder Theorem (``crt_*``).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from .kernels.gauss_jordan import _first_argmax


def bareiss_safe(n: int, amax: int) -> bool:
    """True if an n×n integer matrix with entries |a| ≤ amax can never
    overflow int32 during Bareiss elimination (Hadamard's worst-case bound
    on the cross products before their division).

    Very conservative: real matrices stay far below it, which is why
    ``bareiss_batched`` also checks at run time."""
    def minor_bound(k):
        return (amax * amax * k) ** (k / 2)

    # step k multiplies entries bounded by minor_bound(k+1) with the pivot
    # (also a (k+1)-minor); the difference doubles the magnitude
    worst = max(2 * minor_bound(k + 1) ** 2 for k in range(max(n - 1, 1)))
    return worst < 2**31


class BareissResult(NamedTuple):
    det: torch.Tensor   # [B] int32: exact determinant
    rank: torch.Tensor  # [B] int32: exact rank
    ok: torch.Tensor    # [B] bool: False if int32 overflow was detected


def _first_row(eligible: torch.Tensor) -> torch.Tensor:
    """First True of every row of ``eligible [B, n]`` (0 where none)."""
    return _first_argmax(eligible.to(torch.float32))


def _swap_rows(M, lanes, r, p, do_swap):
    """Exchange rows r and p of each lane where ``do_swap``."""
    row_r, row_p = M[lanes, r].clone(), M[lanes, p].clone()
    sw = do_swap[:, None]
    M[lanes, r] = torch.where(sw, row_p, row_r)
    M[lanes, p] = torch.where(sw, row_r, row_p)


def bareiss_batched(a: torch.Tensor) -> BareissResult:
    """Exact determinant and rank of an integer batch ``[B, n, n]``.

    Fraction-free elimination with first-nonzero-row pivoting and column
    skipping on rank deficiency, in int32.  Overflow is detected before
    each step's products: where the float32 mirror of
    ``2·max|M|·max(|pivot|, 1)`` over the rows at and below the pivot
    reaches 2³¹, the matrix is not ``ok``."""
    bsz, n, _ = a.shape
    M = a.to(torch.int32, copy=True)
    dev = M.device
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(bsz, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    r = torch.zeros(bsz, **i32)
    prev = torch.ones(bsz, **i32)
    sign = torch.ones(bsz, **i32)
    rank = torch.zeros(bsz, **i32)
    ok = torch.ones(bsz, dtype=torch.bool, device=dev)
    for j in range(n):
        # r ≤ j < n: the pivot row is always a row of M
        rl = r.long()
        eligible = (rows[None, :] >= r[:, None]) & (M[:, :, j] != 0)
        p = _first_row(eligible)
        has = eligible.any(dim=1)
        do_swap = has & (p != rl)
        _swap_rows(M, lanes, rl, p, do_swap)
        sign = torch.where(do_swap, -sign, sign)

        #   M[i, :] := (M[i, :]·piv − M[i, j]·row_r) / prev   (exact)
        piv = M[lanes, rl, j]
        pivot_row = M[lanes, rl]
        below = (rows[None, :] > r[:, None]) & has[:, None]
        factors = M[:, :, j] * below

        # the overflow sentinel, before the products: the rows at and
        # below the pivot take part
        active = (rows[None, :] >= r[:, None]).to(torch.float32)
        max_m = (M.abs().to(torch.float32) * active[:, :, None]).amax(
            dim=(1, 2))
        piv_f = piv.abs().to(torch.float32)
        risk = 2.0 * max_m * torch.clamp(piv_f, min=1.0) >= 2.0**31
        ok = ok & ~(risk & has)

        updated = M * piv[:, None, None] - factors[:, :, None] * pivot_row[
            :, None, :]
        # exact division by the previous pivot (the Bareiss invariant)
        updated = torch.div(updated, prev[:, None, None], rounding_mode="floor")
        M = torch.where(below[:, :, None], updated, M)

        rank = rank + has
        prev = torch.where(has, piv, prev)
        r = r + has
    # the last pivot is det(A) up to the swaps' sign (it is the leading
    # n×n minor of the pivoted matrix); rank-deficient matrices have 0
    det = torch.where(rank == n, sign * prev, 0)
    return BareissResult(det.to(torch.int32), rank, ok)


def bareiss_det_batched(a: torch.Tensor) -> torch.Tensor:
    return bareiss_batched(a).det


def bareiss_rank_batched(a: torch.Tensor) -> torch.Tensor:
    return bareiss_batched(a).rank


# ---------------------------------------------------------------------------
# Multi-word exact integers: CRT over 15-bit primes
# ---------------------------------------------------------------------------

#: primes just below 2^15: residue × residue < 2^30, inside int32
_PRIMES = [
    32749, 32719, 32717, 32713, 32707, 32693, 32687, 32653, 32647,
    32633, 32621, 32611, 32609, 32603, 32587, 32579, 32573, 32569,
    32563, 32561, 32537, 32533, 32531, 32507, 32503, 32497, 32491,
    32479, 32467, 32443, 32441, 32429, 32423, 32413, 32411, 32401,
    32381, 32377, 32371, 32369, 32363, 32359, 32353, 32341, 32327,
    32323, 32321, 32309, 32303, 32299, 32297, 32261, 32257, 32251,
    32237, 32233, 32213, 32203, 32191, 32189, 32183, 32173, 32159,
    32143,
]


def _hadamard_bits(n: int, amax: int) -> int:
    """Bits that hold |det| of an n×n matrix with entries ≤ amax
    (Hadamard's bound), plus the sign."""
    if amax == 0:
        return 2
    return int(math.ceil(n * (math.log2(max(amax, 1))
                              + 0.5 * math.log2(n)))) + 2


def _modmul(x, y, p: int):
    return torch.remainder(x * y, p)


def _modinv(x: torch.Tensor, p: int) -> torch.Tensor:
    """Fermat: ``x^(p−2) mod p`` by binary exponentiation over 16 bits."""
    e = p - 2
    acc, base = torch.ones_like(x), x
    for k in range(16):
        if (e >> k) & 1:
            acc = _modmul(acc, base, p)
        base = _modmul(base, base, p)
    return acc


def _as_int32(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.int32)


def _modular_elim_batched(a: torch.Tensor, p: int):
    """Determinant residue and rank of every matrix of ``a [B, n, n]``
    (int32) over Z_p.  Returns ``(det_mod [B]`` in ``[0, p)``,
    ``rank [B])``."""
    bsz, n, _ = a.shape
    M = torch.remainder(a.to(torch.int32), p)          # nonnegative residues
    dev = M.device
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(bsz, device=dev)
    r = torch.zeros(bsz, dtype=torch.int32, device=dev)
    det = torch.ones(bsz, dtype=torch.int32, device=dev)
    rank = torch.zeros(bsz, dtype=torch.int32, device=dev)
    for j in range(n):
        rl = r.long()
        eligible = (rows[None, :] >= r[:, None]) & (M[:, :, j] != 0)
        pidx = _first_row(eligible)
        has = eligible.any(dim=1)
        do_swap = has & (pidx != rl)
        _swap_rows(M, lanes, rl, pidx, do_swap)
        det = torch.where(do_swap, torch.remainder(-det, p), det)

        piv = M[lanes, rl, j]
        pivot_row = M[lanes, rl]
        inv = _modinv(torch.where(has, piv, 1), p)
        below = (rows[None, :] > r[:, None]) & has[:, None]
        factors = _modmul(M[:, :, j], inv[:, None], p) * below
        M = torch.remainder(
            M - _modmul(factors[:, :, None], pivot_row[:, None, :], p), p)
        det = torch.where(has, _modmul(det, piv, p), det)
        rank = rank + has
        r = r + has
    return torch.where(rank == n, det, 0), rank


def _crt(pairs) -> int:
    """CRT of ``[(p, residue)]`` to the symmetric range, in Python ints."""
    P = math.prod(p for p, _ in pairs)
    x = 0
    for p, res in pairs:
        q = P // p
        x += int(res) * q * pow(q, -1, p)
    x %= P
    return x - P if x > P // 2 else x


def crt_det_batched(a, primes=None):
    """Exact determinant of an integer batch of any magnitude (no int32
    bound on the intermediates): modular elimination over enough 15-bit
    primes to cover Hadamard's bound, CRT-reconstructed on the host.

    Returns a Python list of exact ints (they can exceed int64)."""
    a = _as_int32(a)
    bsz, n, _ = a.shape
    amax = int(a.abs().max())
    if primes is None:
        count = max(_hadamard_bits(n, amax) // 15 + 1, 2)
        if count > len(_PRIMES):
            raise ValueError(
                f"determinant bound needs {count} primes; "
                f"only {len(_PRIMES)} configured")
        primes = _PRIMES[:count]
    residues = [_modular_elim_batched(a, p)[0].cpu().numpy() for p in primes]
    return [_crt([(p, res[b]) for p, res in zip(primes, residues)])
            for b in range(bsz)]


def crt_rank_batched(a, primes=None):
    """Rank of an integer batch by modular elimination.  The rank over Z_p
    never exceeds the rational rank and equals it unless p divides every
    maximal nonzero minor; the maximum over several 15-bit primes makes a
    miss vanishingly unlikely."""
    a = _as_int32(a)
    primes = primes or _PRIMES[:3]
    ranks = [_modular_elim_batched(a, p)[1].cpu().numpy() for p in primes]
    return np.maximum.reduce(ranks)


def _modular_solve_batched(a: torch.Tensor, b: torch.Tensor, p: int):
    """Solve ``a x ≡ b (mod p)`` by full Gauss–Jordan over Z_p.

    ``a [B, n, n]``, ``b [B, n]`` int32.  Returns ``(x_mod [B, n],
    det_mod [B], ok [B])``, ``ok`` False where a is singular mod p (the
    caller tries the lane on other primes: det(A) ≠ 0 makes all but
    finitely many succeed)."""
    bsz, n, _ = a.shape
    M = torch.remainder(
        torch.cat([a.to(torch.int32), b.to(torch.int32)[:, :, None]], dim=2),
        p)
    dev = M.device
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(bsz, device=dev)
    det = torch.ones(bsz, dtype=torch.int32, device=dev)
    ok = torch.ones(bsz, dtype=torch.bool, device=dev)
    for j in range(n):
        eligible = (rows[None, :] >= j) & (M[:, :, j] != 0)
        pidx = _first_row(eligible)
        has = eligible.any(dim=1)
        do_swap = has & (pidx != j)
        _swap_rows(M, lanes, torch.full_like(pidx, j), pidx, do_swap)
        det = torch.where(do_swap, torch.remainder(-det, p), det)

        piv = M[:, j, j]
        det = torch.where(has, _modmul(det, piv, p), 0)
        inv = _modinv(torch.where(has, piv, 1), p)
        # normalize the pivot row, then eliminate every other row
        # (Gauss–Jordan): after n steps the left block is I
        pivot_row = _modmul(M[:, j], inv[:, None], p)
        M[:, j] = pivot_row
        others = (rows != j).to(torch.int32)
        factors = M[:, :, j] * others
        M = torch.remainder(
            M - _modmul(factors[:, :, None], pivot_row[:, None, :], p)
            * others[:, None], p)
        ok = ok & has
    return M[:, :, n], torch.where(ok, det, 0), ok


def crt_solve_batched(a, b, primes=None):
    """Exact rational solution of nonsingular integer systems ``a x = b``:
    Cramer's rule assembled from device modular solves.

    Each 15-bit prime gives, in one batched Gauss–Jordan over Z_p,
    ``x_p = A⁻¹b mod p`` and ``det_p``; the integer vector
    ``y = adj(A)·b = det(A)·x`` and ``det(A)`` are CRT-reconstructed on
    the host over enough primes to cover Hadamard's bound, and
    ``x_i = y_i / det`` as a ``fractions.Fraction``.

    Returns ``(xs, dets)``: ``xs[b]`` a list of n Fractions (None where
    the matrix is singular, det 0), ``dets[b]`` the exact determinant."""
    a, b = _as_int32(a), _as_int32(b)
    bsz, n, _ = a.shape
    if primes is not None:
        count, pool = len(primes), list(primes)
    else:
        amax, bmax = int(a.abs().max()), int(b.abs().max())
        # y = adj(A)b: |y_i| ≤ n·bmax·H(n−1, amax); det: H(n, amax)
        bits_y = _hadamard_bits(max(n - 1, 1), amax) + max(
            math.ceil(math.log2(n * max(bmax, 1) + 1)), 1)
        bits = max(bits_y, _hadamard_bits(n, amax))
        count = max(bits // 15 + 1, 2)
        # a prime with det ≡ 0 (mod p) gives that lane no usable residue
        # and is skipped there; a nonzero det under the bound has fewer
        # than `count` distinct 15-bit prime divisors, so a pool of
        # 2·count primes leaves every nonsingular lane `count` residues,
        # and a lane failing on all of them is singular
        pool = _PRIMES
        if 2 * count > len(pool):
            raise ValueError(
                f"solution bound needs a pool of {2 * count} primes; "
                f"only {len(pool)} configured")

    # primes until every lane has `count` usable residues (or the pool is
    # spent: then only singular lanes are short)
    used = []       # (p, y_mod [B, n], det_mod [B], ok [B])
    successes = np.zeros((bsz,), int)
    for p in pool:
        x_p, det_p, ok_p = _modular_solve_batched(a, b, p)
        # y_p = det·x mod p, the Cramer numerator's residue
        used.append((p,
                     torch.remainder(x_p * det_p[:, None], p).cpu().numpy(),
                     det_p.cpu().numpy(), ok_p.cpu().numpy()))
        successes += used[-1][3].astype(int)
        if (successes >= count).all():
            break

    xs, dets = [], []
    for lane in range(bsz):
        lane_used = [(p, ym[lane], dm[lane])
                     for p, ym, dm, ok in used if ok[lane]][:count]
        if len(lane_used) < count:
            if lane_used:
                raise ValueError(
                    f"lane {lane}: only {len(lane_used)} of {count} "
                    f"usable primes; prime pool exhausted")
            # singular on every prime tried: det = 0
            xs.append(None)
            dets.append(0)
            continue
        det = _crt([(p, dm) for p, _, dm in lane_used])
        dets.append(det)
        xs.append([Fraction(_crt([(p, ym[i]) for p, ym, _ in lane_used]), det)
                   for i in range(n)])
    return xs, dets
