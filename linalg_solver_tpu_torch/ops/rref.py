"""Batched Gauss–Jordan reduction (RREF) with event recording
(counterpart of ``linalg_solver_tpu.ops.rref``).

A forward sweep over the columns (pivot search, swap, normalise,
eliminate below), then a reverse sweep above the pivots, as the
reference's two ``fori_loop`` bodies.  Here each sweep is a Python loop
over columns whose every step is one batched tensor operation over
``[B, m, n]`` (what the reference's ``vmap`` means); the pivot row and
count are per-matrix tensors, so no step branches on a value.

Pivot rules:

- ``"first"`` — the first row at or below the pivot row whose entry
  exceeds ``tol`` in magnitude (with ``tol=0`` on integer-valued input,
  the exact path's pivot sequence);
- ``"partial"`` — the largest magnitude at or below the pivot row, the
  first of equal ones (``jnp.argmax``'s order: a NaN counts as the
  largest).

Every structural step is recorded into a fixed-size event buffer
``(code, arg1, arg2)``: ``SWAP(r, i)``, ``NORM(r, j)``,
``ELIM_BELOW(j, r)``, ``ELIM_ABOVE(j, r)``.

Where the reference reads a row at an index past the matrix (the pivot
cursor after the last row, the ``-1`` padding of an empty pivot list),
JAX clamps or wraps the index and the update multiplies that row by
zero; the port reads the same row, so a non-finite entry there spreads
as it does in the reference.  Elimination updates are ``x − f·row``,
rounded once (``gauss_jordan.fms``), as XLA on the CPU fuses them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from .kernels.gauss_jordan import _first_argmax, fms

# Event codes.
EV_SWAP = 0
EV_NORM = 1
EV_ELIM_BELOW = 2
EV_ELIM_ABOVE = 3

EVENT_NAMES = {
    EV_SWAP: "SWAP",
    EV_NORM: "NORM",
    EV_ELIM_BELOW: "ELIM_BELOW",
    EV_ELIM_ABOVE: "ELIM_ABOVE",
}

PIVOT_RULES = ("first", "partial")

Tol = Union[float, torch.Tensor]


class RREFResult(NamedTuple):
    """Result of a (batched) Gauss–Jordan reduction.  Fields are padded to
    static sizes; ``num_pivots`` / ``num_events`` give the valid
    prefixes."""

    reduced: torch.Tensor      # [..., m, n] reduced matrix
    pivot_rows: torch.Tensor   # [..., k_max] int32, padded with -1
    pivot_cols: torch.Tensor   # [..., k_max] int32, padded with -1
    num_pivots: torch.Tensor   # [...] int32
    det: torch.Tensor          # [...] product of pivots × swap sign (0
                               #   unless min(m, bar_col) pivots)
    events: torch.Tensor       # [..., e_max, 3] int32
    num_events: torch.Tensor   # [...] int32


def batch_tol(tol: Tol, bsz: int, dtype, device) -> torch.Tensor:
    """``tol`` (a number, a 0-d tensor or one per matrix ``[B]``) as a
    ``[B]`` tensor."""
    t = torch.as_tensor(tol, dtype=dtype, device=device)
    return t.expand(bsz) if t.dim() == 0 else t.reshape(bsz)


def _rows_at(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, idx[b], :]`` for ``a [B, m, n]``."""
    return torch.take_along_dim(a, idx[:, None, None], dim=1)[:, 0]


def rref_batched(
    a: torch.Tensor,
    bar_col: Optional[int] = None,
    tol: Tol = 0.0,
    pivot_rule: str = "first",
    record_events: bool = True,
) -> RREFResult:
    """Gauss–Jordan reduce every ``[m, n]`` matrix of ``a [B, m, n]``.

    ``bar_col`` bounds pivoting (exclusive): columns at or after the bar
    are transformed but never chosen as pivots (``[A | b]`` uses ``n - 1``,
    ``[A | I]`` A's width); it defaults to ``n - 1``.  ``tol`` is one
    threshold or one per matrix ``[B]``."""
    if pivot_rule not in PIVOT_RULES:
        raise ValueError(f"unknown pivot rule: {pivot_rule!r}")
    bsz, m, n = a.shape
    if bar_col is None:
        bar_col = n - 1
    if not 0 <= bar_col <= n:
        raise ValueError(f"bar_col {bar_col} out of range for {n} columns")
    k_max = min(m, bar_col)
    e_max = max(4 * k_max, 1)
    A = a.to(torch.promote_types(a.dtype, torch.float32), copy=True)
    dt, dev = A.dtype, A.device
    tol = batch_tol(tol, bsz, dt, dev)
    rows = torch.arange(m, device=dev)
    lanes = torch.arange(bsz, device=dev)
    r = torch.zeros(bsz, dtype=torch.long, device=dev)
    k = torch.zeros(bsz, dtype=torch.long, device=dev)
    piv_rows = torch.full((bsz, k_max), -1, dtype=torch.int32, device=dev)
    piv_cols = torch.full((bsz, k_max), -1, dtype=torch.int32, device=dev)
    det = torch.ones(bsz, dtype=dt, device=dev)
    events = torch.zeros(bsz, e_max, 3, dtype=torch.int32, device=dev)
    ec = torch.zeros(bsz, dtype=torch.long, device=dev)

    def push(code, x, y, enabled):
        nonlocal ec
        if not record_events:
            return
        at = ec.clamp(max=e_max - 1)
        entry = torch.stack([torch.full_like(x, code), x, y], dim=1).to(
            torch.int32)
        events[lanes, at] = torch.where(enabled[:, None], entry,
                                        events[lanes, at])
        ec = ec + enabled.long()

    for j in range(bar_col if k_max > 0 else 0):
        col = A[:, :, j]
        eligible = rows[None, :] >= r[:, None]
        if pivot_rule == "first":
            mask = (col.abs() > tol[:, None]) & eligible
            p = mask.to(torch.int8).argmax(dim=1)
            has = mask.any(dim=1)
        else:
            masked = torch.where(eligible, col.abs(), -torch.inf)
            p = _first_argmax(masked)
            has = masked[lanes, p] > tol
        rc = r.clamp(max=m - 1)  # JAX clamps the cursor past the last row

        # swap rows r and p
        do_swap = has & (p != r)
        order = rows.expand(bsz, m).clone()
        order[lanes, rc] = torch.where(do_swap, p, rc)
        order[lanes, p] = torch.where(do_swap, rc, p)
        A = torch.take_along_dim(A, order[:, :, None], dim=1)
        det = torch.where(do_swap, -det, det)
        push(EV_SWAP, r, p, do_swap)

        # normalise the pivot row (events gated by tolerance: a float
        # pivot lands an ulp off the exact path's 1)
        pivot_val = A[lanes, rc, j]
        needs_norm = has & ((pivot_val - 1).abs() > tol)
        row_r = A[lanes, rc]
        normalized = row_r / torch.where(has, pivot_val, 1.0)[:, None]
        A[lanes, rc] = torch.where(has[:, None], normalized, row_r)
        det = torch.where(has, det * pivot_val, det)
        push(EV_NORM, r, torch.full_like(r, j), needs_norm)

        # eliminate below
        factors = torch.where((rows[None, :] > r[:, None]) & has[:, None],
                              A[:, :, j], 0.0)
        any_elim = (factors.abs() > tol[:, None]).any(dim=1)
        A = fms(A, factors[:, :, None], A[lanes, rc][:, None, :])
        push(EV_ELIM_BELOW, torch.full_like(r, j), r, any_elim)

        # record the pivot
        at = k.clamp(max=k_max - 1)
        piv_rows[lanes, at] = torch.where(has, r.to(torch.int32),
                                          piv_rows[lanes, at])
        piv_cols[lanes, at] = torch.where(has, j, piv_cols[lanes, at])
        k = k + has.long()
        r = r + has.long()

    # backward sweep: eliminate above the pivots, last pivot first
    for step in range(k_max):
        kk = k - 1 - step
        valid = kk >= 0
        kk_safe = kk.clamp(min=0)
        row = piv_rows[lanes, kk_safe].long() % m   # -1 wraps, as in JAX
        colj = piv_cols[lanes, kk_safe].long() % n
        col = torch.take_along_dim(A, colj[:, None, None], dim=2)[:, :, 0]
        factors = torch.where((rows[None, :] < row[:, None]) & valid[:, None],
                              col, 0.0)
        any_elim = (factors.abs() > tol[:, None]).any(dim=1)
        A = fms(A, factors[:, :, None], _rows_at(A, row)[:, None, :])
        push(EV_ELIM_ABOVE, piv_cols[lanes, kk_safe].long(),
             piv_rows[lanes, kk_safe].long(), any_elim)

    det = torch.where(k == min(m, bar_col), det, torch.zeros_like(det))
    return RREFResult(A, piv_rows, piv_cols, k.to(torch.int32), det, events,
                      ec.to(torch.int32))


def rref(
    a: torch.Tensor,
    bar_col: Optional[int] = None,
    tol: float = 0.0,
    pivot_rule: str = "first",
    record_events: bool = True,
) -> RREFResult:
    """Gauss–Jordan reduce a single ``[m, n]`` matrix (``rref_batched`` on a
    batch of one)."""
    res = rref_batched(a[None], bar_col=bar_col, tol=tol,
                       pivot_rule=pivot_rule, record_events=record_events)
    return RREFResult(*(t[0] for t in res))
