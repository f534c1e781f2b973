"""Large-N batched solve (counterpart of ``linalg_solver_tpu.ops.lu_large``).

Two solvers for ``a [B, N, N]`` with a vector RHS ``b [B, N]`` at N in
the thousands, where the panel kernels' shared memory no longer holds a
useful panel:

- ``large_solve_rbt``: two-sided random butterflies (kernel 4, through
  ``rbt._butterfly_two_sided_fast``), then block elimination without
  pivoting: each ``nb×nb`` diagonal block inverted by the pivot-free Schur
  recursion (``ops.lu_recursive``) or, with ``diag_engine="pivoted"``,
  by the library's pivoted inverse, the off-diagonal blocks and the
  trailing updates as batched products, ``ir_steps`` rounds of f32
  refinement against the original system and the RBT gate; the flagged
  systems go to ``large_solve_mixed``, compacted.
- ``large_solve_mixed``: blocked LU with partial pivoting, the ``nb``-wide
  getrf panels by the library (``torch.linalg.lu_factor_ex``; the
  reference's ``lax.linalg.lu`` is library code too), the trailing
  updates in one reduced-precision pass, then f32 refinement.

``_bf16_mm`` is the reference's one-pass bf16 product with f32
accumulation; here it runs under ``factor_matmuls("bfloat16")``: TF32 on
the card, full f32 on the CPU.  Casting the inputs to torch's bf16 would
also round the product's *output* to bf16, which the reference's
``preferred_element_type=f32`` does not.  The factors therefore differ
from the reference's by design; the refined solutions agree.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..utils.precision import f32_matmuls, factor_matmuls
from .kernels.gauss_jordan import take_rows
from .lu_blocked import rescue_flagged
from .lu_recursive import inverse_nopivot_recursive


def _bf16_mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The trailing-update product in one reduced-precision pass (TF32
    on the card)."""
    with factor_matmuls("bfloat16"):
        return x @ y


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``m @ v`` for ``m [B, i, j]``, ``v [B, j]``."""
    return (m @ v[:, :, None])[:, :, 0]


class LargeLU(NamedTuple):
    """Per-phase factors of the pivoted blocked LU (lists of length
    ``N/nb``; phase k's arrays cover the trailing ``M_k = N − k·nb``
    rows)."""
    lu11: List[torch.Tensor]   # [B, nb, nb] packed L11\U11
    l21: List[torch.Tensor]    # [B, M − nb, nb]
    u12: List[torch.Tensor]    # [B, nb, M − nb]
    perm: List[torch.Tensor]   # [B, M] row permutation of the trailing block


def _split_tri(lu11: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    eye = torch.eye(lu11.shape[-1], dtype=lu11.dtype, device=lu11.device)
    return torch.tril(lu11, -1) + eye, torch.triu(lu11)


def _pivots_to_perm(piv: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK pivots ``[B, k]`` (1-based, swaps applied in order) → the
    permutation ``[B, m]``: row i of ``P A`` is row ``perm[i]`` of A."""
    B, k = piv.shape
    perm = torch.arange(m, device=piv.device).repeat(B, 1)
    ar = torch.arange(B, device=piv.device)
    for j in range(k):
        pj = piv[:, j].long() - 1
        at_j, at_p = perm[ar, j], perm[ar, pj]
        perm[ar, j] = at_p
        perm[ar, pj] = at_j
    return perm


def large_lu_factor(a: torch.Tensor, nb: int = 128) -> LargeLU:
    """Pivoted blocked LU of ``a [B, N, N]`` (N divisible by ``nb``):
    library getrf on each ``[M, nb]`` panel, the panel's row order applied
    to the trailing block by a gather, ``U12`` by a unit-lower triangular
    solve, and the trailing update through ``_bf16_mm``."""
    B, n, _ = a.shape
    if n % nb:
        raise ValueError(f"N={n} must be divisible by nb={nb}")
    A = a
    lu11s, l21s, u12s, perms = [], [], [], []
    for k in range(n // nb):
        lu, piv, _ = torch.linalg.lu_factor_ex(A[:, :, :nb])
        perm = _pivots_to_perm(piv, A.shape[1])
        lu11s.append(lu[:, :nb])
        l21s.append(lu[:, nb:])
        perms.append(perm)
        if A.shape[1] > nb:
            rest = take_rows(A[:, :, nb:], perm)
            l11, _ = _split_tri(lu[:, :nb])
            u12 = torch.linalg.solve_triangular(
                l11, rest[:, :nb], upper=False, unitriangular=True)
            u12s.append(u12)
            A = rest[:, nb:] - _bf16_mm(lu[:, nb:], u12)
        else:
            u12s.append(a.new_zeros(B, nb, 0))
    return LargeLU(lu11s, l21s, u12s, perms)


def large_lu_solve(fac: LargeLU, b: torch.Tensor) -> torch.Tensor:
    """Solve through the phase factors: ``b [B, N]`` → ``x [B, N]``."""
    nb = fac.lu11[0].shape[-1]
    rhs = b
    ys = []
    for lu11, l21, perm in zip(fac.lu11, fac.l21, fac.perm):
        rhs = torch.take_along_dim(rhs, perm, dim=1)
        l11, _ = _split_tri(lu11)
        y = torch.linalg.solve_triangular(
            l11, rhs[:, :nb, None], upper=False, unitriangular=True)[:, :, 0]
        ys.append(y)
        rhs = rhs[:, nb:]
        if rhs.shape[1]:
            rhs = rhs - _mv(l21, y)
    x = b.new_zeros(b.shape[0], 0)
    for k in reversed(range(len(fac.lu11))):
        _, u11 = _split_tri(fac.lu11[k])
        r = ys[k]
        if x.shape[1]:
            r = r - _mv(fac.u12[k], x)
        xk = torch.linalg.solve_triangular(u11, r[:, :, None],
                                           upper=True)[:, :, 0]
        x = torch.cat([xk, x], dim=1)
    return x


@f32_matmuls()
def large_solve_mixed(
    a: torch.Tensor, b: torch.Tensor, nb: int = 128, ir_steps: int = 1
) -> torch.Tensor:
    """Factor and solve ``a [B, N, N] @ x = b [B, N]`` with the pivoted
    blocked LU, then ``ir_steps`` rounds of f32 refinement.  Returns f32;
    a singular system comes back non-finite."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    fac = large_lu_factor(a32, nb=nb)
    x = large_lu_solve(fac, b32)
    for _ in range(ir_steps):
        x = x + large_lu_solve(fac, b32 - _mv(a32, x))
    return x


class LargeRBT(NamedTuple):
    """Block elimination ``A = L·U`` of the butterflied matrix (lists of
    length ``N/nb``): the diagonal blocks of U held as their inverses,
    L's blocks below the diagonal as ``A21 D⁻¹``, U's right of it raw."""
    dinv: List[torch.Tensor]   # [B, nb, nb]
    l21h: List[torch.Tensor]   # [B, M − nb, nb]
    a12: List[torch.Tensor]    # [B, nb, M − nb]
    ok: torch.Tensor           # [B] every leaf pivot nonzero, D⁻¹ finite


#: the ``diag_engine`` values of the reference's ``large_solve_rbt``
DIAG_ENGINES = ("recursive", "pivoted")


def _pivoted_block_inverse(d: torch.Tensor) -> torch.Tensor:
    """The library's pivoted inverse of ``d [B, nb, nb]`` (``jnp.linalg.
    inv`` in the reference), NaN where a block is exactly singular, as
    the reference's comes back non-finite; nothing raises."""
    inv, info = torch.linalg.inv_ex(d)
    return torch.where((info == 0)[:, None, None], inv,
                       torch.full_like(inv, float("nan")))


def _rbt_block_factor(a_p: torch.Tensor, nb: int,
                      diag_engine: str = "recursive") -> LargeRBT:
    """Block elimination without pivoting of ``a_p [B, N, N]``; each
    diagonal block (a Schur complement of a leading minor, nonsingular
    with probability 1 after the butterflies) inverted by the Schur
    recursion with 16-wide leaves (``diag_engine="recursive"``, the
    reference's default) or by the library's pivoted inverse
    (``"pivoted"``).  A system is flagged where a leaf pivot is zero or a
    block inverse is not finite."""
    if diag_engine not in DIAG_ENGINES:
        raise ValueError(f"diag_engine {diag_engine!r}; one of "
                         f"{DIAG_ENGINES}")
    B, n, _ = a_p.shape
    A = a_p
    dinvs, l21hs, a12s = [], [], []
    ok = torch.ones(B, dtype=torch.bool, device=a_p.device)
    for _ in range(n // nb):
        if diag_engine == "recursive":
            dinv, dok = inverse_nopivot_recursive(A[:, :nb, :nb], leaf=16)
            ok = ok & dok
        else:
            dinv = _pivoted_block_inverse(A[:, :nb, :nb])
        ok = ok & torch.isfinite(dinv).all(dim=2).all(dim=1)
        dinvs.append(dinv)
        if A.shape[1] > nb:
            a12 = A[:, :nb, nb:]
            l21h = _bf16_mm(A[:, nb:, :nb], dinv)
            a12s.append(a12)
            l21hs.append(l21h)
            A = A[:, nb:, nb:] - _bf16_mm(l21h, a12)
        else:
            a12s.append(a_p.new_zeros(B, nb, 0))
            l21hs.append(a_p.new_zeros(B, 0, nb))
    return LargeRBT(dinvs, l21hs, a12s, ok)


def _rbt_block_solve(fac: LargeRBT, b: torch.Tensor, nb: int):
    """Block forward and back substitution of ``b [B, N]``."""
    rhs = b
    ys = []
    for l21h in fac.l21h:
        y = rhs[:, :nb]
        ys.append(y)
        rhs = rhs[:, nb:]
        if rhs.shape[1]:
            rhs = rhs - _mv(l21h, y)
    x = b.new_zeros(b.shape[0], 0)
    for k in reversed(range(len(fac.dinv))):
        r = ys[k]
        if x.shape[1]:
            r = r - _mv(fac.a12[k], x)
        x = torch.cat([_mv(fac.dinv[k], r), x], dim=1)
    return x


@f32_matmuls()
def large_solve_rbt(
    a: torch.Tensor,
    b: torch.Tensor,
    nb: int = 128,
    ir_steps: int = 2,
    fallback: bool = True,
    diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    diag_engine: str = "recursive",
) -> torch.Tensor:
    """Solve ``a [B, N, N] @ x = b [B, N]`` (N divisible by ``nb`` and by
    4) by RBT block elimination: butterflies ``UᵀAV`` at depth
    ``shrink_depth(N)`` (``diags``: a ``[2, N]`` (U, V) pair, by default
    the seeded draw ``rbt.MAIN_SEEDS``), ``_rbt_block_factor`` (its
    ``diag_engine``: ``"recursive"`` or ``"pivoted"``), the block
    solve, ``ir_steps`` rounds of f32 refinement against the original
    system, and (``fallback``) the RBT gate (``rbt.refinement_gate``: a
    leaf pivot zero or a block inverse non-finite, the last correction
    or residual too large).  The flagged systems are solved again by
    ``large_solve_mixed`` with two refinement rounds, compacted.  Returns
    f32 ``[B, N]``."""
    from . import rbt

    n = a.shape[-1]
    if n % nb:
        raise ValueError(f"N={n} must be divisible by nb={nb}")
    a32 = a.to(torch.float32).contiguous()
    b32 = b.to(torch.float32)
    diags = diags or rbt.default_diags(n, rbt.MAIN_SEEDS, str(a32.device))
    d = rbt.shrink_depth(n)
    du, dv = diags[0][:d], diags[1][:d]

    def bf(v, levels, trans):
        return rbt.butterfly_apply(v[:, :, None], levels, trans=trans)[:, :, 0]

    fac = _rbt_block_factor(
        rbt._butterfly_two_sided_fast(a32, *diags, trans=True), nb,
        diag_engine)
    x = bf(_rbt_block_solve(fac, bf(b32, du, True), nb), dv, False)
    rmax = xmax = zcmax = None
    for step in range(ir_steps):
        r = b32 - _mv(a32, x)
        zc = bf(_rbt_block_solve(fac, bf(r, du, True), nb), dv, False)
        if step == ir_steps - 1:
            rmax, xmax, zcmax = (t.abs().amax(dim=1) for t in (r, x, zc))
        x = x + zc
    if not fallback:
        return x
    bad = rbt.refinement_gate(
        ~fac.ok, ir_steps, a32, b32[:, :, None], x[:, :, None],
        a32.abs().amax(dim=(1, 2)), b32.abs().amax(dim=1), rmax, xmax,
        zcmax)
    return rescue_flagged(
        x, bad, lambda a_s, b_s: large_solve_mixed(a_s, b_s, nb=nb,
                                                   ir_steps=2), a32, b32)
