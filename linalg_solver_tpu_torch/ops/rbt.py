"""Random-butterfly-preconditioned pivot-free LU solve
(counterpart of ``linalg_solver_tpu.ops.rbt``).

``A' = Uᵀ A V`` with depth-≤2 random butterflies (Parker's
construction) makes LU without pivoting stable for generic input with
probability ~1.  Refinement runs against the original system, and a
per-system gate sends the systems the probabilistic argument fails to a
rescue: the same pipeline with a second butterfly draw, then the
pivoted ``lu_blocked`` solve or inverse.  Two engines:

- ``"fused"``: the solve in one launch of the fused kernel
  (``ops.kernels.solve_fused``), where ``solve_fused.fits(N, k)``;
- ``"kernel"``, the phase engine: the two-sided butterfly kernel
  (``ops.kernels.butterfly``), then one launch of the no-pivot panel
  kernel (``ops.kernels.lu_nopivot``) per ``nb``-wide phase, with the
  triangular inverses, substitutions and trailing updates as batched
  products.  It serves a matrix RHS wider than the fused kernel takes,
  N past its reach, and the inverse (``inverse_rbt_batched``).

Butterfly diagonals are ``[depth, N]`` tensors (``rbt_diags``) or, as
the kernel takes them, ``[2, N]`` (``pad_diags``).  They are drawn on a
CPU ``torch.Generator`` so the draw does not depend on the device, and
every entry point takes them as an argument so that tests can feed the
JAX package's draw (``diags_from_numpy``).
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.precision import f32_matmuls, factor_matmuls
from . import lu_blocked

_SQRT_HALF = 0.7071067811865476

#: generator seeds of the main draw (U, V) and of the rescue redraw;
#: the JAX package uses the same numbers as PRNG keys
MAIN_SEEDS = (17, 29)
RESCUE_SEEDS = (101, 103)


def shrink_depth(n: int) -> int:
    """Largest butterfly depth ≤ 2 whose segments stay even for ``n``."""
    d = 2
    while d > 1 and (n >> (d - 1)) % 2:
        d -= 1
    return d


def rbt_diags(
    n: int, depth: int, generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Per-level butterfly diagonals, ``[depth, n]`` f32 with entries
    ``exp(r/10)``, r ~ U(−1, 1), drawn on ``generator`` (a CPU
    generator) and then moved to ``device``."""
    r = torch.rand((depth, n), generator=generator, dtype=torch.float32)
    return torch.exp((2.0 * r - 1.0) / 10.0).to(device)


def pad_diags(diags: torch.Tensor) -> torch.Tensor:
    """``[depth, n]`` → ``[2, n]``: level 1 all ones at depth 1 (the
    kernel reads only the first ``depth`` levels), as ``diags_lanes``
    does without its 128-lane broadcast."""
    if diags.shape[0] == 1:
        return torch.cat([diags, torch.ones_like(diags)], dim=0)
    return diags


def diags_from_numpy(
    du_levels: Sequence[np.ndarray], dv_levels: Sequence[np.ndarray],
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's per-level diagonals (``rbt_diags(key, n, d)``
    as numpy arrays) → the port's ``[2, n]`` (U, V) tensors."""
    def conv(levels):
        stacked = np.stack([np.asarray(v, np.float32) for v in levels])
        return pad_diags(torch.from_numpy(stacked)).to(device)

    return conv(du_levels), conv(dv_levels)


@functools.lru_cache(maxsize=16)
def default_diags(
    n: int, seeds: Tuple[int, int], device: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The seeded (U, V) draw at depth ``shrink_depth(n)``, ``[2, n]``
    each.  Cached: a draw costs a host-to-device copy, and callers never
    write to the returned tensors."""
    d = shrink_depth(n)
    return tuple(
        pad_diags(rbt_diags(n, d, torch.Generator().manual_seed(s), device))
        for s in seeds
    )


#: generator seed of the inverse's Rademacher probe (a PRNG key in the
#: JAX package, as the butterfly seeds are)
PROBE_SEED = 83


@functools.lru_cache(maxsize=16)
def default_probe(n: int, device: str) -> torch.Tensor:
    """The seeded Rademacher probe of the inverse's gate: ``[n]`` f32 of
    ±1 drawn on a CPU generator seeded ``PROBE_SEED``, moved to
    ``device``.  Cached like ``default_diags``."""
    g = torch.Generator().manual_seed(PROBE_SEED)
    bits = torch.randint(0, 2, (n,), generator=g, dtype=torch.int64)
    return (2.0 * bits - 1.0).to(torch.float32).to(device)


def probe_from_numpy(
    v: np.ndarray, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """The JAX package's probe (``jax.random.rademacher`` as a numpy
    array) → the port's ``[n]`` f32 tensor."""
    return torch.from_numpy(np.asarray(v, np.float32).copy()).to(device)


def _bf_level(x: torch.Tensor, r: torch.Tensor, seg: int, trans: bool):
    """One butterfly level along axis 1 of ``x [B, N, K]``: block-diag of
    ``N/seg`` butterflies ``(1/√2)[[R0, R1], [R0, −R1]]`` with per-level
    diagonal ``r [N]``; ``trans`` applies the transpose."""
    B, n, K = x.shape
    h = seg // 2
    xs = x.reshape(B, n // seg, 2, h, K)
    rs = r.reshape(n // seg, 2, h)[None, :, :, :, None]
    top, bot = xs[:, :, 0], xs[:, :, 1]
    r0, r1 = rs[:, :, 0], rs[:, :, 1]
    if trans:
        out_top = r0 * (top + bot)
        out_bot = r1 * (top - bot)
    else:
        out_top = r0 * top + r1 * bot
        out_bot = r0 * top - r1 * bot
    out = torch.stack([out_top, out_bot], dim=2) * _SQRT_HALF
    return out.reshape(B, n, K)


def butterfly_apply(
    x: torch.Tensor, diags, trans: bool = False
) -> torch.Tensor:
    """Apply the depth-d butterfly ``W`` (or ``Wᵀ``) along axis 1 of
    ``[B, N, K]``; ``diags`` holds exactly d levels.  ``trans`` applies
    levels 0..d-1, otherwise d-1..0."""
    n = x.shape[1]
    levels = list(range(len(diags)))
    if not trans:
        levels = levels[::-1]
    for lvl in levels:
        x = _bf_level(x, diags[lvl], n >> lvl, trans)
    return x


def _absmax(t: torch.Tensor) -> torch.Tensor:
    """Per-system max|t| of ``[B, N, K]`` (NaN-propagating)."""
    return t.abs().amax(dim=(1, 2))


def refinement_gate(
    bad: torch.Tensor, ir_steps: int, a32: torch.Tensor, b3: torch.Tensor,
    x: torch.Tensor, amax: torch.Tensor, bmax: torch.Tensor, rmax, xmax,
    zcmax,
) -> torch.Tensor:
    """The solve's per-system failure flags, ORed into ``bad`` (zero
    pivots): the last refinement correction ``zcmax`` above 0.3·max|x|,
    or (``ir_steps`` ≥ 2) the last residual ``rmax`` above
    1e-4·max(|b|, |A|·|x|); with ``ir_steps=0`` one explicit residual
    against the loose 1e-2 bound.  NaN-proof: ``nan <= t`` is False."""
    eps = torch.tensor(1e-30, dtype=torch.float32, device=a32.device)
    if ir_steps == 0:
        with f32_matmuls():
            resid = b3 - a32 @ x
        scale = torch.maximum(bmax, amax * _absmax(x))
        return bad | ~(_absmax(resid) <= 1e-2 * torch.maximum(scale, eps))
    bad = bad | ~(zcmax <= 0.3 * torch.maximum(xmax, eps))
    if ir_steps >= 2:
        scale = torch.maximum(bmax, amax * xmax)
        bad = bad | ~(rmax <= 1e-4 * torch.maximum(scale, eps))
    return bad


def _compacted_rescue(
    core2: Callable, pivoted: Callable, x: torch.Tensor, bad: torch.Tensor,
    *operands: torch.Tensor,
) -> torch.Tensor:
    """Re-solve exactly the flagged systems: gather their ``operands``
    (``[B, ...]`` each), run ``core2(*sub) -> (y, bad2)`` (the pipeline
    with the rescue draw) on them, send the ones that fail again to
    ``pivoted(*sub) -> y``, and write the results back into ``x``.  Every
    system is independent, so the answers do not depend on which others
    were flagged.

    Each decision reads one scalar to the host
    (``lu_blocked.rescue_flagged``): on CUDA that waits for the kernels.
    The first is the one host read of a clean call; moving the decision
    onto the card is on the roadmap."""
    def again(*sub):
        y, bad2 = core2(*sub)
        return lu_blocked.rescue_flagged(y, bad2, pivoted, *sub)

    return lu_blocked.rescue_flagged(x, bad, again, *operands)


# --- the phase engine --------------------------------------------------

#: panel widths the phase engine tries, in order: the JAX package's
#: lists for the solve (rbt.py, by N) and the inverse (dispatch.py)
SOLVE_NB_SMALL = (32, 64, 48, 16, 8)   # N <= 384
SOLVE_NB_LARGE = (64, 48, 32, 16, 8)
INVERSE_NB = (64, 48, 32, 16, 8)


def phase_nb(n: int, nb: Optional[int], prefs: Sequence[int]) -> int:
    """The panel width of the phase engine at N = n: ``nb``, or else the
    first of ``prefs`` that divides ``n`` and whose first panel
    ``[n, nb]`` the no-pivot kernel takes (``lu_nopivot.fits``), or else
    one panel of width ``n`` (even ``n``), as the reference falls back
    to."""
    from .kernels import lu_nopivot

    if nb is None:
        nb = next((w for w in prefs
                   if n % w == 0 and lu_nopivot.fits(n, w)), None)
        if nb is None and n % 2:
            raise ValueError(f"N={n}: the butterflies need an even N")
        if nb is None:
            nb = n
    nb = min(nb, n)
    if n % nb:
        raise ValueError(f"N={n} is not a multiple of nb={nb}")
    if not lu_nopivot.fits(n, nb):
        raise ValueError(f"N={n}, nb={nb}: the first panel is past the "
                         f"no-pivot kernel's shared memory")
    return nb


def _butterfly_two_sided_fast(
    a: torch.Tensor, diags_rows: torch.Tensor, diags_cols: torch.Tensor,
    trans: bool,
) -> torch.Tensor:
    """Two-sided butterfly of ``[B, N, N]`` by the one-pass kernel at depth
    ``shrink_depth(N)``: ``trans=True`` is the preconditioning ``UᵀAV``
    (diagonals (u, v)), ``trans=False`` the reconstruction ``V X Uᵀ``
    (diagonals (v, u)).  The kernel takes every even N, so the reference's
    per-level fallback is not needed."""
    from .kernels.butterfly import butterfly_two_sided

    return butterfly_two_sided(a, diags_rows, diags_cols,
                               shrink_depth(a.shape[-1]), trans, trans)


class _NoPivotPhases(NamedTuple):
    panels: List[torch.Tensor]     # factored panels [B, M_i, nb]
    u12s: List[torch.Tensor]       # U12 blocks [B, nb, N - (i+1) nb]
    l11s_inv: List[torch.Tensor]   # inverses of the unit-lower L11 blocks
    u11s_inv: List[torch.Tensor]   # inverses of the U11 blocks
    ok: torch.Tensor               # [B] every pivot nonzero
    ys: Optional[List[torch.Tensor]]  # forward-substituted RHS blocks


def _nopivot_lu_phases(
    a: torch.Tensor, nb: int, rhs: Optional[torch.Tensor] = None
) -> _NoPivotPhases:
    """Phase loop around the no-pivot panel kernel: with the row order
    fixed, both dimensions of the trailing block shrink every phase.  The
    glue products run at the caller's matmul precision.  With ``rhs
    [B, N, K]`` the forward substitution rides along."""
    from .kernels.lu_nopivot import panel_factor_nopivot

    B, n, _ = a.shape
    trail = a
    eye_nb = torch.eye(nb, dtype=a.dtype, device=a.device)
    ok = torch.ones(B, dtype=torch.bool, device=a.device)
    panels, u12s, l11s_inv, l11u11s = [], [], [], []
    ys = [] if rhs is not None else None
    for _ in range(0, n, nb):
        panel_u, pok = panel_factor_nopivot(trail[:, :, :nb], nb)
        ok = ok & pok
        panels.append(panel_u)
        l11u11 = panel_u[:, :nb, :]
        l21 = panel_u[:, nb:, :]
        l11i = lu_blocked.invert_unit_lower(torch.tril(l11u11, -1) + eye_nb)
        l11s_inv.append(l11i)
        l11u11s.append(l11u11)
        if ys is not None:
            y = l11i @ rhs[:, :nb, :]
            ys.append(y)
            rhs = rhs[:, nb:, :] - l21 @ y
        if trail.shape[2] > nb:
            u12 = l11i @ trail[:, :nb, nb:]
            u12s.append(u12)
            trail = trail[:, nb:, nb:] - l21 @ u12
        else:
            trail = trail[:, nb:, nb:]
    u11s_inv = [lu_blocked.invert_upper(torch.triu(x)) for x in l11u11s]
    return _NoPivotPhases(panels, u12s, l11s_inv, u11s_inv, ok, ys)


def _nopivot_solve(ph: _NoPivotPhases, b3: torch.Tensor, m: int, nb: int):
    """Forward and back substitution of a fresh RHS ``[B, N, K]`` against
    the phases (the refinement's solve)."""
    rhs = b3
    ys = []
    for i in range(m):
        y = ph.l11s_inv[i] @ rhs[:, :nb, :]
        ys.append(y)
        rhs = rhs[:, nb:, :]
        if rhs.shape[1]:
            rhs = rhs - ph.panels[i][:, nb:, :] @ y
    return lu_blocked._phases_backward(ph, ys, m, nb)


def _solve_core(
    a32: torch.Tensor, b3: torch.Tensor, diags: Tuple[torch.Tensor, ...],
    nb: int, ir_steps: int, factor_precision: str,
):
    """One rescue-free pass of the phase-engine solve of ``a32 [B, N, N]``
    against ``b3 [B, N, K]`` (f32): butterflies, no-pivot phases,
    substitution, ``ir_steps`` refinement rounds against the original
    system.  Returns ``(x, bad)``."""
    n = a32.shape[-1]
    m = n // nb
    d = shrink_depth(n)
    du, dv = diags[0][:d], diags[1][:d]
    with factor_matmuls(factor_precision):
        a_p = _butterfly_two_sided_fast(a32, *diags, trans=True)
        b_p = butterfly_apply(b3, du, trans=True)
        ph = _nopivot_lu_phases(a_p, nb, rhs=b_p)
        x = butterfly_apply(lu_blocked._phases_backward(ph, ph.ys, m, nb),
                            dv, trans=False)
    rmax = xmax = zcmax = None
    for step in range(ir_steps):
        last = step == ir_steps - 1
        with f32_matmuls():
            resid = b3 - a32 @ x
        if last:
            rmax, xmax = _absmax(resid), _absmax(x)
        with factor_matmuls(factor_precision):
            z = _nopivot_solve(ph, butterfly_apply(resid, du, trans=True),
                               m, nb)
        zc = butterfly_apply(z, dv, trans=False)
        if last:
            zcmax = _absmax(zc)
        x = x + zc
    return x, refinement_gate(~ph.ok, ir_steps, a32, b3, x, _absmax(a32),
                              _absmax(b3), rmax, xmax, zcmax)


def _inverse_core(
    a32: torch.Tensor, diags: Tuple[torch.Tensor, ...], nb: int,
    ns_steps: int, factor_precision: str,
):
    """One rescue-free pass of the phase-engine inverse ``A⁻¹ = V
    (UᵀAV)⁻¹ Uᵀ`` of ``a32 [B, N, N]`` (f32), then ``ns_steps``
    Newton–Schulz rounds against the original matrix.  Returns ``(X,
    bad)``: a zero pivot, or the last residual ``max|I − A X|`` above
    1e-2 (NaN-proof)."""
    B, n, _ = a32.shape
    m = n // nb
    with factor_matmuls(factor_precision):
        a_p = _butterfly_two_sided_fast(a32, *diags, trans=True)
        if m == 1:
            ph = _nopivot_lu_phases(a_p, nb)
            inv_p = ph.u11s_inv[0] @ ph.l11s_inv[0]
        else:
            eye = torch.eye(n, dtype=a32.dtype, device=a32.device)
            ph = _nopivot_lu_phases(a_p, nb, rhs=eye.expand(B, n, n))
            inv_p = lu_blocked._phases_backward(ph, ph.ys, m, nb)
        x = _butterfly_two_sided_fast(inv_p, diags[1], diags[0], trans=False)
    eye = torch.eye(n, dtype=a32.dtype, device=a32.device)
    rmax = None
    with f32_matmuls():
        for _ in range(ns_steps):
            r = eye - a32 @ x
            rmax = _absmax(r)
            x = x + x @ r
        if rmax is None:
            rmax = _absmax(eye - a32 @ x)
    return x, ~ph.ok | ~(rmax <= 1e-2)


def _pivoted_inverse(a32: torch.Tensor) -> torch.Tensor:
    """The deterministic pivoted inverse (innermost rescue): the pivoted
    Gauss–Jordan kernel where it takes ``[A | I]``, else the library's
    pivoted LU."""
    from .kernels import gauss_jordan

    n = a32.shape[-1]
    if gauss_jordan.fits(n, 2 * n):
        return gauss_jordan.inverse_batched(a32)
    return lu_blocked.blocked_inverse_batched(a32)


def inverse_rbt_batched(
    a: torch.Tensor,
    nb: Optional[int] = None,
    ns_steps: int = 1,
    factor_precision: str = "float32",
    diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rescue_diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Batched inverse of ``a [B, N, N]`` (N even) by the phase engine:
    ``A⁻¹ = V (UᵀAV)⁻¹ Uᵀ`` with ``ns_steps`` Newton–Schulz rounds against
    the original matrix; the counterpart of ``pallas_inverse_rbt_batched``
    (``engine="kernel"``, ``fallback="redraw"``).  The flagged matrices
    (zero pivot, or ``max|I − A X|`` above 1e-2) go through the rescue
    draw and then the pivoted inverse, compacted.  ``nb`` defaults to the
    first of ``INVERSE_NB`` that divides N and fits the panel kernel.
    Computes in f32 and returns the input's floating dtype."""
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must be [B, N, N]; got {tuple(a.shape)}")
    if ns_steps < 0:
        raise ValueError(f"ns_steps must be >= 0, got {ns_steps}")
    n = a.shape[-1]
    nb = phase_nb(n, nb, INVERSE_NB)
    a32 = a.to(torch.float32).contiguous()
    dev = str(a32.device)
    core = functools.partial(_inverse_core, nb=nb, ns_steps=ns_steps,
                             factor_precision=factor_precision)
    x, bad = core(a32, diags or default_diags(n, MAIN_SEEDS, dev))
    redraw = rescue_diags or default_diags(n, RESCUE_SEEDS, dev)
    x = _compacted_rescue(lambda s: core(s, redraw), _pivoted_inverse, x,
                          bad, a32)
    return x.to(a.dtype) if a.is_floating_point() else x


def solve_rbt_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    ir_steps: int = 2,
    diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rescue_diags: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    nb: Optional[int] = None,
    factor_precision: str = "bfloat16",
) -> torch.Tensor:
    """Solve ``a @ x = b`` for ``a [B, N, N]`` and ``b [B, N]`` or
    ``[B, N, k]`` (N even) with the lane-compacted rescue; the
    counterpart of ``pallas_solve_rbt_batched``.

    The engine is chosen as the reference's ``engine="auto"`` chooses it:
    the fused kernel where ``solve_fused.fits(N, k)``, the phase engine
    (``"kernel"``) elsewhere.  ``nb`` and ``factor_precision`` are the
    phase engine's: the panel width (by default the first of
    ``SOLVE_NB_SMALL`` / ``SOLVE_NB_LARGE`` that divides N and fits the
    panel kernel) and the precision of its glue products (``"bfloat16"``:
    TF32 on the card).  ``diags`` /
    ``rescue_diags`` are ``[2, N]`` (U, V) pairs; by default the seeded
    draws ``MAIN_SEEDS`` / ``RESCUE_SEEDS``.  Returns f32, shaped like
    ``b``."""
    from .kernels.solve_fused import fits, solve_fused_rbt

    n = a.shape[-1]
    vector_input = b.dim() == 2
    b3 = b.unsqueeze(-1) if vector_input else b
    a32 = a.to(torch.float32).contiguous()
    b3 = b3.to(torch.float32).contiguous()
    dev = str(a32.device)
    diags = diags or default_diags(n, MAIN_SEEDS, dev)
    redraw = rescue_diags or default_diags(n, RESCUE_SEEDS, dev)
    if fits(n, b3.shape[-1]):
        def core(a_s, b_s, d):
            return solve_fused_rbt(a_s, b_s, *d, ir_steps=ir_steps)
    else:
        prefs = SOLVE_NB_SMALL if n <= 384 else SOLVE_NB_LARGE
        core = functools.partial(
            _solve_core, nb=phase_nb(n, nb, prefs), ir_steps=ir_steps,
            factor_precision=factor_precision)
    x, bad = core(a32, b3, diags)
    x = _compacted_rescue(
        lambda a_s, b_s: core(a_s, b_s, redraw),
        lambda a_s, b_s: lu_blocked.blocked_solve_batched(a_s, b_s,
                                                      ir_steps=2),
        x, bad, a32, b3,
    )
    return x.squeeze(-1) if vector_input else x
