"""Blocked, batch-vectorised LU with partial pivoting (counterpart of
``linalg_solver_tpu.ops.lu_blocked``).

Ported:

- the pivoted phase loop around the masked panel kernel
  (``ops.kernels.lu_panel``, kernel 6): ``_pallas_lu_phases`` never moves
  a row; each phase's panel kernel skips the rows earlier phases
  pivoted, the trailing update is a batched product with those rows
  masked to zero, and the per-phase ``U12 = L11⁻¹ A12`` blocks and
  diagonal-block inverses are kept aside.  On it: ``pallas_solve_batched``
  (the ``"blocked_pallas"`` solve), ``pallas_solve_mixed_batched`` (the
  ``"mixed"`` solve: factor products at ``factor_precision``, f32
  refinement, and a compacted pivoted rescue of the systems whose
  residual stays high), ``pallas_det_batched``, ``blocked_lu_batched``
  (packed L\\U: the reference's ``panel_backend="pallas"``),
  ``blocked_lu_solve`` and
  ``blocked_inverse_batched(panel_backend="pallas")``.  A panel past the
  kernel's shared memory is factored in two levels (``nbi``-wide
  sub-panels, the reference's own split), never by another solver.
- the reference's ``panel_backend="xla"`` names: ``blocked_solve_batched``
  and ``blocked_inverse_batched`` (the last rungs of the rescues),
  ``blocked_lu_batched(panel_backend="xla")`` and
  ``blocked_det_batched`` (the ``"blocked"`` backend of
  ``ops.dispatch``).  The JAX versions are plain XLA code (a blocked
  partial-pivoting LU), not Pallas kernels, so here they are the
  library's pivoted LU (plus f32 refinement for the solve); the packed
  factors carry the diagonal-block inverses, so ``blocked_lu_solve``
  serves them unchanged.
- ``invert_unit_lower`` and ``invert_upper``: the same divide-and-conquer
  and Neumann-product math as the reference, in batched products.

Row gathers are ``torch.take_along_dim`` (``gauss_jordan.take_rows``) and
row scatters ``scatter_add_``, where the reference uses exact one-hot
matmuls (``ops/select.py``, a TPU workaround); on finite values both are
exact.  Products run at the caller's matmul precision, as the
reference's run at its ``default_matmul_precision``, except where a
function pins it as the reference does (``f32_matmuls``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls, factor_matmuls
from .kernels.gauss_jordan import _perm_parity, take_rows

#: below this size, triangular inverses use the Neumann product instead
#: of recursing (the reference's ``_NEUMANN_BASE``)
_NEUMANN_BASE = 64


class BlockedLUResult(NamedTuple):
    lu: torch.Tensor     # [B, N, N] packed L\U (after pivoting)
    perm: torch.Tensor   # [B, N] int32: row i of PA is row perm[i] of A
    sign: torch.Tensor   # [B] parity of perm, ±1
    ok: torch.Tensor     # [B] every pivot nonzero
    #: inverses of the nb×nb diagonal blocks of L and U, [B, m, nb, nb]
    l11_inv: torch.Tensor
    u11_inv: torch.Tensor


def blocked_solve_batched(
    a: torch.Tensor, b: torch.Tensor, nb: int = 128, ir_steps: int = 1
) -> torch.Tensor:
    """Factor (partial pivoting) and solve ``a @ x = b`` for ``a [B, N, N]``
    and ``b [B, N]`` or ``[B, N, K]``, then ``ir_steps`` rounds of f32
    refinement against ``a``.  A singular system comes back non-finite;
    nothing raises.  ``nb`` is the reference's panel width, taken for its
    signature: the library's LU blocks by itself."""
    vector_input = b.dim() == a.dim() - 1
    a32 = a.to(torch.float32)
    b3 = (b.unsqueeze(-1) if vector_input else b).to(torch.float32)
    lu, piv, _ = torch.linalg.lu_factor_ex(a32)
    x = torch.linalg.lu_solve(lu, piv, b3)
    with f32_matmuls():
        for _ in range(ir_steps):
            x = x + torch.linalg.lu_solve(lu, piv, b3 - a32 @ x)
    return x.squeeze(-1) if vector_input else x


def blocked_inverse_batched(
    a: torch.Tensor, nb: int = 64, panel_backend: str = "xla"
) -> torch.Tensor:
    """Batched inverse of ``a [B, N, N]`` in f32.  ``panel_backend=
    "pallas"``: the pivoted phase loop on the panel kernel
    (``blocked_lu_batched``), then the block substitution against I with
    its cached diagonal-block inverses; ``"xla"``: the library's pivoted
    LU and its solve against I.  A singular matrix comes back
    non-finite."""
    if panel_backend == "pallas":
        with f32_matmuls():
            res = blocked_lu_batched(a, nb=nb)
            n = a.shape[-1]
            eye = torch.eye(n, dtype=torch.float32, device=a.device)
            return blocked_lu_solve(res, eye.expand(a.shape[0], n, n))
    if panel_backend != "xla":
        raise ValueError(f"panel_backend {panel_backend!r}; one of "
                         f"('xla', 'pallas')")
    a32 = a.to(torch.float32)
    lu, piv, _ = torch.linalg.lu_factor_ex(a32)
    eye = torch.eye(a32.shape[-1], dtype=torch.float32, device=a32.device)
    return torch.linalg.lu_solve(lu, piv, eye.expand_as(a32))


def _neumann_inv_unit(m: torch.Tensor) -> torch.Tensor:
    """Inverse of ``I + m`` for strictly triangular (nilpotent) ``m``:
    ``Π_j (I + (−m)^{2^j})``, exact after ``ceil(log2 n)`` factors."""
    n = m.shape[-1]
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    p = -m
    acc = eye + p
    for _ in range(max((n - 1).bit_length(), 1) - 1):
        p = p @ p
        acc = acc + acc @ p
    return acc


def invert_unit_lower(lo: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched unit-lower-triangular ``[..., n, n]``: divide
    and conquer down to ``_NEUMANN_BASE``, then the Neumann product.
    ``[[A, 0], [C, B]]⁻¹ = [[A⁻¹, 0], [−B⁻¹ C A⁻¹, B⁻¹]]``."""
    n = lo.shape[-1]
    if n == 1:
        return torch.ones_like(lo)
    if n <= _NEUMANN_BASE:
        return _neumann_inv_unit(torch.tril(lo, -1))
    h = n // 2
    ai = invert_unit_lower(lo[..., :h, :h])
    bi = invert_unit_lower(lo[..., h:, h:])
    top = torch.cat([ai, torch.zeros_like(lo[..., :h, h:])], dim=-1)
    bottom = torch.cat([-(bi @ (lo[..., h:, :h] @ ai)), bi], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def invert_upper(up: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched upper-triangular ``[..., n, n]`` (non-unit
    diagonal): divide and conquer down to ``_NEUMANN_BASE``, then
    ``U = D (I + D⁻¹ strict(U))`` with the Neumann product."""
    n = up.shape[-1]
    if n == 1:
        return 1.0 / up
    if n <= _NEUMANN_BASE:
        d = torch.diagonal(up, dim1=-2, dim2=-1)
        k = torch.triu(up, 1) / d[..., :, None]
        return _neumann_inv_unit(k) / d[..., None, :]
    h = n // 2
    ai = invert_upper(up[..., :h, :h])
    ci = invert_upper(up[..., h:, h:])
    top = torch.cat([ai, -(ai @ (up[..., :h, h:] @ ci))], dim=-1)
    bottom = torch.cat([torch.zeros_like(up[..., h:, :h]), ci], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _panel_factor(panel: torch.Tensor, k0: int, nb: int,
                  row_idx: torch.Tensor, tol):
    """Factor one ``[B, N, nb]`` panel whose column ``jj`` is global column
    ``k0 + jj`` (the reference's XLA panel loop, in plain torch; the
    distributed LU factors its broadcast panel with it).  Step ``jj``
    pivots on the first maximum of ``|col|`` over the rows ``≥ k0 + jj``
    (``jnp.argmax``'s rule, so ties pick the same row), swaps it into
    place, writes the multipliers below the diagonal and updates the
    columns right of ``jj``.  Returns the factored panel, the panel-local
    permutation ``[B, N]`` int32 (row i of the factored panel is row
    ``local_perm[i]`` of the input), the parity ``[B]`` and ``ok [B]``
    (every pivot above ``tol``)."""
    from .kernels.gauss_jordan import _first_argmax

    B, N, w = panel.shape
    dev = panel.device
    panel = panel.clone()
    bi = torch.arange(B, device=dev)
    local_perm = row_idx.to(torch.int32).expand(B, N).clone()
    sign = torch.ones(B, dtype=panel.dtype, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    cols = torch.arange(w, device=dev)
    for jj in range(nb):
        j = k0 + jj
        col = panel[:, :, jj]
        masked = torch.where(row_idx[None, :] >= j, col.abs(), -torch.inf)
        p = _first_argmax(masked)
        has = masked.gather(1, p[:, None])[:, 0] > tol
        do_swap = has & (p != j)
        src = torch.where(do_swap, p, j)
        row_j, row_p = panel[:, j, :].clone(), panel[bi, src, :]
        panel[bi, src, :] = row_j
        panel[:, j, :] = row_p
        lp_j, lp_p = local_perm[:, j].clone(), local_perm[bi, src]
        local_perm[bi, src] = lp_j
        local_perm[:, j] = lp_p
        sign = torch.where(do_swap, -sign, sign)
        col = panel[:, :, jj]
        safe = torch.where(has, panel[:, j, jj], 1.0)
        below = row_idx[None, :] > j
        factors = torch.where(below & has[:, None], col / safe[:, None], 0.0)
        right = (cols > jj).to(panel.dtype)
        panel = panel - factors[:, :, None] * panel[:, j, None, :] * right
        panel[:, :, jj] = torch.where(below, factors, col)
        ok = ok & has
    return panel, local_perm, sign, ok


def rescue_flagged(x: torch.Tensor, bad: torch.Tensor, solve,
                   *operands: torch.Tensor) -> torch.Tensor:
    """``x`` with the systems flagged in ``bad`` replaced by ``solve`` of
    their rows of ``operands``; deciding reads one scalar to the host."""
    if int(bad.sum()) == 0:
        return x
    idx = torch.nonzero(bad).squeeze(1)
    return x.index_copy(0, idx, solve(*(t.index_select(0, idx)
                                        for t in operands)))


# --- the pivoted phase loop around the panel kernel ---------------------


def panel_split(n: int, nb: int, nbi: Optional[int] = None) -> Optional[int]:
    """The sub-panel width of the phase loop's ``[n, nb]`` panels: ``nbi``
    as given; else None (one level) where the panel kernel takes
    ``[n, nb]``; else the widest even ``nbi`` dividing ``nb`` whose
    ``[n, nbi]`` sub-panel it takes.  Raises where none does."""
    from .kernels import lu_panel

    if nbi is not None:
        if nbi < nb and nb % nbi:
            raise ValueError(f"nbi={nbi} must divide nb={nb}")
        return nbi
    if lu_panel.fits(n, nb):
        return None
    nbi = next((w for w in range(nb - 2, 1, -2)
                if nb % w == 0 and lu_panel.fits(n, w)), None)
    if nbi is None:
        raise ValueError(f"N={n}, nb={nb}: no even sub-panel width divides "
                         f"nb and fits the panel kernel's shared memory")
    return nbi


def _panel_pallas_two_level(panel, pivoted, nb: int, nbi: Optional[int]):
    """Factor one ``[B, N, nb]`` panel with the panel kernel, in one level
    (``nbi`` None or ≥ nb) or in two: ``nbi``-wide sub-panels through the
    kernel, and between them the inner ``U12`` rows scattered into this
    sub-panel's pivot rows and the masked rank-``nbi`` update of the
    unpivoted rows.  Algebraically identical to one level.  Returns
    ``(panel_u, piv_row, pivoted, ok)``."""
    from .kernels import lu_panel

    if nbi is None or nbi >= nb:
        panel_u, _, piv_row, pivoted, ok = lu_panel.panel_factor_masked(
            panel, pivoted, nb)
        return panel_u, piv_row, pivoted, ok
    B, n, _ = panel.shape
    eye_i = torch.eye(nbi, dtype=panel.dtype, device=panel.device)
    ok = torch.ones(B, dtype=torch.bool, device=panel.device)
    piv_parts, sub_panels = [], []
    rest = panel
    for _ in range(0, nb, nbi):
        subp, rest = rest[:, :, :nbi], rest[:, :, nbi:]
        subp_u, _, piv_i, pivoted, pok = lu_panel.panel_factor_masked(
            subp, pivoted, nbi)
        ok = ok & pok
        piv_parts.append(piv_i)
        sub_panels.append(subp_u)
        if rest.shape[2]:
            l11i = invert_unit_lower(
                torch.tril(take_rows(subp_u, piv_i), -1) + eye_i)
            u12i = l11i @ take_rows(rest, piv_i)
            unpiv = (pivoted == 0).to(panel.dtype)
            idx = piv_i.long()
            rowmask = torch.zeros(B, n, dtype=panel.dtype,
                                  device=panel.device).scatter_add_(
                1, idx, torch.ones_like(idx, dtype=panel.dtype))
            scatter = torch.zeros_like(rest).scatter_add_(
                1, idx[:, :, None].expand(-1, -1, rest.shape[2]), u12i)
            rest = (rest * (1.0 - rowmask[:, :, None]) + scatter
                    - (subp_u * unpiv[:, :, None]) @ u12i)
    return (torch.cat(sub_panels, dim=2), torch.cat(piv_parts, dim=1),
            pivoted, ok)


class _PallasLUPhases(NamedTuple):
    """What the phase loop keeps: per phase, the eliminated ``[B, N, nb]``
    panel with rows in their original order, the pivot row of each step,
    the ``U12`` block (all phases but the last), the inverses of the L11
    and U11 blocks and U11's diagonal; ``ok [B]``; and, with a RHS, the
    forward-substituted blocks ``ys``."""
    panels: List[torch.Tensor]
    piv_rows: List[torch.Tensor]
    u12s: List[torch.Tensor]
    l11s_inv: List[torch.Tensor]
    u11s_inv: List[Optional[torch.Tensor]]
    u11_diags: List[torch.Tensor]
    ok: torch.Tensor
    ys: Optional[List[torch.Tensor]] = None


def _pallas_lu_phases(
    a: torch.Tensor, nb: int, need_u11_inv: bool = True,
    rhs: Optional[torch.Tensor] = None, nbi: Optional[int] = None,
) -> _PallasLUPhases:
    """Phase loop of the deferred-reordering blocked LU around the masked
    panel kernel (one launch per phase, or ``nb / nbi`` in two levels;
    ``panel_split`` picks ``nbi`` where the panel is too wide for the
    kernel).  Rows never move; each phase's pivot rows give L11\\U11 and
    ``A12`` by a gather, the rows not pivoted yet hold L21, and the
    trailing update ``trail − L21·U12`` leaves the pivoted rows alone.
    With ``rhs [B, N, K]`` the forward substitution ``L y = P b`` rides
    along.  Products run at the caller's matmul precision."""
    B, n, _ = a.shape
    nbi = panel_split(n, nb, nbi)
    trail = a.to(torch.float32)
    eye_nb = torch.eye(nb, dtype=trail.dtype, device=trail.device)
    pivoted = torch.zeros(B, n, dtype=torch.int32, device=trail.device)
    ok = torch.ones(B, dtype=torch.bool, device=trail.device)
    panels, piv_rows, u12s, l11s_inv, l11u11s = [], [], [], [], []
    ys = [] if rhs is not None else None
    if rhs is not None:
        rhs = rhs.to(torch.float32)
    for k0 in range(0, n, nb):
        panel, trail = trail[:, :, :nb], trail[:, :, nb:]
        panel_u, piv_row, pivoted, pok = _panel_pallas_two_level(
            panel, pivoted, nb, nbi)
        ok = ok & pok
        piv_rows.append(piv_row)
        panels.append(panel_u)
        l11u11 = take_rows(panel_u, piv_row)
        l11i = invert_unit_lower(torch.tril(l11u11, -1) + eye_nb)
        l11s_inv.append(l11i)
        l11u11s.append(l11u11)
        last = k0 + nb >= n
        if not last or ys is not None:
            l21m = panel_u * (pivoted == 0).to(panel_u.dtype)[:, :, None]
        if ys is not None:
            y = l11i @ take_rows(rhs, piv_row)
            ys.append(y)
            if not last:
                rhs = rhs - l21m @ y
        if not last:
            u12 = l11i @ take_rows(trail, piv_row)
            u12s.append(u12)
            trail = trail - l21m @ u12
    # one stacked chain for the U11 blocks of all phases
    m = len(l11u11s)
    stacked = torch.cat(l11u11s, dim=0)                 # [m·B, nb, nb]
    u11_diags = list(torch.diagonal(stacked, dim1=-2, dim2=-1)
                     .reshape(m, B, nb))
    if need_u11_inv:
        u11s_inv = list(invert_upper(torch.triu(stacked))
                        .reshape(m, B, nb, nb))
    else:
        u11s_inv = [None] * m
    return _PallasLUPhases(panels, piv_rows, u12s, l11s_inv, u11s_inv,
                           u11_diags, ok, ys)


def _phases_backward(ph, ys, m: int, nb: int) -> torch.Tensor:
    """Block back substitution ``U x = y`` against the phases' kept
    artifacts: ``U_ij`` (j > i) is a slice of phase i's ``U12`` block,
    the diagonal blocks go through their cached inverses.  Shared with
    the RBT phase engine (``ops.rbt``), whose phases keep the same
    fields."""
    xs: List = [None] * m
    for i in reversed(range(m)):
        r = ys[i]
        for j in range(i + 1, m):
            w0 = (j - i - 1) * nb
            r = r - ph.u12s[i][:, :, w0:w0 + nb] @ xs[j]
        xs[i] = ph.u11s_inv[i] @ r
    return torch.cat(xs, dim=1)


def _phases_forward(ph: _PallasLUPhases, later_masks, b3, m: int):
    """Forward substitution ``L y = P b3`` of a fresh RHS ``[B, N, K]``
    against the phases: ``later_masks[i] [B, N, 1]`` is 1 on the rows
    pivoted after phase i, which hold phase i's L21 block."""
    rhs = b3
    ys = []
    for i in range(m):
        y = ph.l11s_inv[i] @ take_rows(rhs, ph.piv_rows[i])
        ys.append(y)
        if i < m - 1:
            rhs = rhs - (ph.panels[i] * later_masks[i]) @ y
    return ys


def _phases_solve(ph: _PallasLUPhases, later_masks, b3, m: int, nb: int):
    """Forward and blocked back substitution of a fresh RHS."""
    return _phases_backward(ph, _phases_forward(ph, later_masks, b3, m),
                            m, nb)


def _later_masks(ph: _PallasLUPhases, n: int) -> List[torch.Tensor]:
    """Per phase i, ``[B, N, 1]`` f32: 1 on the rows no phase ≤ i chose
    as a pivot row."""
    cum = torch.zeros(ph.ok.shape[0], n, dtype=torch.float32,
                      device=ph.ok.device)
    masks = []
    for piv_row in ph.piv_rows:
        idx = piv_row.long()
        cum = cum.scatter_add(1, idx, torch.ones_like(idx, dtype=cum.dtype))
        masks.append((1.0 - cum)[:, :, None])
    return masks


def _panel_width(n: int, nb: int) -> int:
    """The phase loop's panel width ``min(nb, n)``; raises where it does
    not divide ``n``."""
    nb = min(nb, n)
    if n % nb:
        raise ValueError(f"N={n} must be divisible by nb={nb}")
    return nb


def _pallas_lu(a: torch.Tensor, nb: int, nbi: Optional[int] = None
               ) -> BlockedLUResult:
    """Packed L\\U from the phase loop and one final row gather; the
    ``U12`` blocks are written over the rows right of each diagonal
    block."""
    ph = _pallas_lu_phases(a, nb, nbi=nbi)
    perm = torch.cat(ph.piv_rows, dim=1)
    lu = take_rows(torch.cat(ph.panels, dim=2), perm)
    for p, u12 in enumerate(ph.u12s):
        lu[:, p * nb:(p + 1) * nb, (p + 1) * nb:] = u12
    return BlockedLUResult(
        lu, perm, _perm_parity(perm).to(lu.dtype), ph.ok,
        torch.stack(ph.l11s_inv, dim=1), torch.stack(ph.u11s_inv, dim=1))


def _library_lu(a: torch.Tensor, nb: int) -> BlockedLUResult:
    """The library's pivoted LU as a ``BlockedLUResult``: ``perm`` from
    its row swaps, ``ok`` where every pivot is nonzero (and not NaN, as
    the reference's ``|pivot| > 0`` test), the inverses of the nb×nb
    diagonal blocks from ``invert_unit_lower`` / ``invert_upper``."""
    n = a.shape[-1]
    lu, piv, _ = torch.linalg.lu_factor_ex(a.to(torch.float32))
    p_mat, _, _ = torch.lu_unpack(lu, piv, unpack_data=False)
    perm = p_mat.argmax(dim=-2).to(torch.int32)   # A = P L U: PᵀA = LU
    diag = torch.diagonal(lu, dim1=-2, dim2=-1)
    m = n // nb
    blocks = torch.stack([lu[:, i * nb:(i + 1) * nb, i * nb:(i + 1) * nb]
                          for i in range(m)], dim=1)
    eye = torch.eye(nb, dtype=lu.dtype, device=lu.device)
    return BlockedLUResult(
        lu, perm, _perm_parity(perm).to(lu.dtype), (diag.abs() > 0).all(-1),
        invert_unit_lower(torch.tril(blocks, -1) + eye),
        invert_upper(torch.triu(blocks)))


@f32_matmuls()
def blocked_lu_batched(a: torch.Tensor, nb: int = 128,
                       panel_backend: str = "pallas") -> BlockedLUResult:
    """Blocked batched LU ``P A = L U`` of every matrix of ``a [B, N, N]``
    (f32, N divisible by ``min(nb, N)``), with the diagonal-block
    inverses that ``blocked_lu_solve`` uses.  ``panel_backend="pallas"``
    (the port's default, which the ``blocked_pallas`` paths take): the
    phase loop on the panel kernel; ``"xla"`` (the reference's default,
    the ``"blocked"`` backend): the library's pivoted LU, as the
    reference's XLA panel loops are plain XLA code."""
    nb = _panel_width(a.shape[-1], nb)
    if panel_backend == "pallas":
        return _pallas_lu(a, nb)
    if panel_backend == "xla":
        return _library_lu(a, nb)
    raise ValueError(f"panel_backend {panel_backend!r}; one of "
                     f"('xla', 'pallas')")


def blocked_det_batched(a: torch.Tensor, nb: int = 128) -> torch.Tensor:
    """Determinants from the library's LU (the reference's XLA-panel
    ``blocked_det_batched``): sign × product of U's diagonal, 0 where a
    pivot is zero.  ``nb`` falls back to N where ``min(nb, N)`` does not
    divide it, as in the reference; the panel kernel's determinant is
    ``pallas_det_batched``."""
    n = a.shape[-1]
    nb = min(nb, n)
    if n % nb:
        nb = n
    res = blocked_lu_batched(a, nb=nb, panel_backend="xla")
    d = res.sign * torch.diagonal(res.lu, dim1=-2, dim2=-1).prod(dim=-1)
    return torch.where(res.ok, d, torch.zeros_like(d))


@f32_matmuls()
def blocked_lu_solve(res: BlockedLUResult, b: torch.Tensor) -> torch.Tensor:
    """Block forward and back substitution through the packed factors of
    ``res`` for ``b [B, N]`` or ``[B, N, K]``: the diagonal blocks through
    the cached inverses (their width is the panel width), the
    off-diagonal blocks as batched products.  The reference's
    triangular-solve branch serves its XLA panel backends, which do not
    cache the inverses; here every producer caches them, the library's
    LU (``panel_backend="xla"``) too."""
    lu, perm = res.lu, res.perm
    n = lu.shape[-1]
    nb = res.l11_inv.shape[-1]
    vector_input = b.dim() == 2
    b3 = (b[:, :, None] if vector_input else b).to(lu.dtype)
    pb = take_rows(b3, perm)
    m = n // nb

    def blk(i, j):
        return lu[:, i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]

    ys = []
    for i in range(m):
        rhs = pb[:, i * nb:(i + 1) * nb]
        for j in range(i):
            rhs = rhs - blk(i, j) @ ys[j]
        ys.append(res.l11_inv[:, i] @ rhs)
    xs: List = [None] * m
    for i in reversed(range(m)):
        rhs = ys[i]
        for j in range(i + 1, m):
            rhs = rhs - blk(i, j) @ xs[j]
        xs[i] = res.u11_inv[:, i] @ rhs
    x = torch.cat(xs, dim=1)
    return x[:, :, 0] if vector_input else x


@f32_matmuls()
def pallas_solve_batched(
    a: torch.Tensor, b: torch.Tensor, nb: int = 128
) -> torch.Tensor:
    """Factor and solve on the phase loop without assembling the packed
    L\\U: the forward substitution rides the loop, the back substitution
    uses the kept ``U12`` blocks and diagonal-block inverses.  ``b`` is
    ``[B, N]`` or ``[B, N, K]``; returns f32 shaped like ``b``."""
    n = a.shape[-1]
    nb = _panel_width(n, nb)
    vector_input = b.dim() == 2
    b3 = b[:, :, None] if vector_input else b
    ph = _pallas_lu_phases(a, nb, rhs=b3)
    x = _phases_backward(ph, ph.ys, n // nb, nb)
    return x[:, :, 0] if vector_input else x


def pallas_solve_mixed_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    nb: int = 64,
    ir_steps: int = 2,
    factor_precision: str = "bfloat16",
    fallback: bool = True,
    nbi: Optional[int] = None,
) -> torch.Tensor:
    """Mixed-precision factor and refined solve (the ``dsgesv`` recipe):
    the phase loop's products at ``factor_precision`` (``"bfloat16"``:
    TF32 on the card, full f32 on the CPU; the panel kernel and the row
    gathers are exact either way), then ``ir_steps`` rounds of refinement
    with the residual ``b − A x`` in full f32 and the correction through
    the same factors.

    ``fallback``: a system whose final residual exceeds 1e-5·max(|b|,
    |A|·|x|) (NaN-proof in the reference's direction: a NaN residual is
    not flagged) is solved again by the pivoted ``blocked_solve_batched``
    with two refinement rounds.  Only the flagged systems are gathered
    and solved; deciding reads one scalar to the host per call.  Returns
    f32 shaped like ``b``."""
    n = a.shape[-1]
    nb = _panel_width(n, nb)
    m = n // nb
    vector_input = b.dim() == 2
    b3 = (b[:, :, None] if vector_input else b).to(torch.float32)
    a32 = a.to(torch.float32)
    with factor_matmuls(factor_precision):
        ph = _pallas_lu_phases(a32, nb, rhs=b3, nbi=nbi)
        later_masks = _later_masks(ph, n)
        x = _phases_backward(ph, ph.ys, m, nb)
    for _ in range(ir_steps):
        with f32_matmuls():
            resid = b3 - a32 @ x
        with factor_matmuls(factor_precision):
            x = x + _phases_solve(ph, later_masks, resid, m, nb)
    if fallback:
        with f32_matmuls():
            resid = b3 - a32 @ x
        scale = torch.maximum(
            b3.abs().amax(dim=(1, 2)),
            a32.abs().amax(dim=(1, 2)) * x.abs().amax(dim=(1, 2)))
        bad = resid.abs().amax(dim=(1, 2)) > 1e-5 * scale.clamp_min(1e-30)
        x = rescue_flagged(
            x, bad, lambda a_s, b_s: blocked_solve_batched(a_s, b_s,
                                                           ir_steps=2),
            a32, b3)
    return x[:, :, 0] if vector_input else x


@f32_matmuls()
def pallas_det_batched(a: torch.Tensor, nb: int = 128) -> torch.Tensor:
    """Determinant on the phase loop: the product of the U11 diagonals
    times the parity of the pivot order, 0 where a step found no pivot;
    no packed L\\U.  N must be divisible by ``min(nb, N)``."""
    ph = _pallas_lu_phases(a, _panel_width(a.shape[-1], nb),
                           need_u11_inv=False)
    perm = torch.cat(ph.piv_rows, dim=1)
    diag = torch.cat(ph.u11_diags, dim=1)
    det = _perm_parity(perm).to(diag.dtype) * torch.prod(diag, dim=-1)
    return torch.where(ph.ok, det, torch.zeros_like(det))
