"""Host-side replay of device-recorded elimination events into LaTeX
(counterpart of ``linalg_solver_tpu.trace.events``).

The device path (``ops.rref``) records compact ``(code, arg1, arg2)``
events — row swaps, pivot normalizations, eliminations.  This module
replays that event stream against the *original host-side matrix* using
exact arithmetic (``fractions.Fraction``), regenerating the same
step-by-step derivation the exact path produces (identical S/N/E labels,
``\\StepSim`` chains, and snapshot layout), so composed device
computations still read as human derivations: the device computes, the
host narrates.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..exact import elimination
from ..ops.rref import EV_ELIM_ABOVE, EV_ELIM_BELOW, EV_NORM, EV_SWAP
from ..utils.fmt import cformat, make_latex_augmented_matrix
from ..utils.trace import capture_logs, log

#: the pivot threshold of ``replay_solve_trace``'s device reduction
REPLAY_TOL = 1e-5


def _to_exact(items: Sequence[Sequence[Any]]) -> List[List[Any]]:
    """Rows as exact numbers: an integer or a float (exactly its binary
    value, as ``sympy.Rational(float)``) becomes a ``Fraction``; other
    entries stay as they are."""
    out = []
    for row in items:
        exact_row = []
        for x in row:
            if isinstance(x, np.generic):
                x = x.item()
            if isinstance(x, (int, float)) and not isinstance(x, bool):
                exact_row.append(Fraction(x))
            else:
                exact_row.append(x)
        out.append(exact_row)
    return out


def replay_rref_events(
    host_items: Sequence[Sequence[Any]],
    events,
    num_events: int,
    bar_col: Optional[int] = None,
) -> Tuple[List[List[Any]], List[str], List[Tuple[str, str]]]:
    """Re-derive the elimination on the host by applying the device event
    stream (``[e_max, 3]``, numpy or a tensor) to an exact copy of the
    input.

    Returns ``(reduced_items, snapshot_latex_list, steps)`` in the same
    format as the exact path's ``row_reduce``.
    """
    A = _to_exact(host_items)
    n = len(A[0])
    if bar_col is None:
        bar_col = n - 1

    snapshots = [make_latex_augmented_matrix(A, bar_col=bar_col)]
    steps: List[Tuple[str, str]] = []

    def snapshot(prefix: str, description: str) -> None:
        snapshots.append(make_latex_augmented_matrix(A, bar_col=bar_col))
        steps.append((f"{prefix}{len(steps)}", description))

    for idx in range(int(num_events)):
        code, x, y = (int(v) for v in events[idx])
        if code == EV_SWAP:
            r, i = x, y
            A[r], A[i] = A[i], A[r]
            snapshot(
                "S", r"Výměna řádků $R_{%d}$ a $R_{%d}$" % (r + 1, i + 1)
            )
        elif code == EV_NORM:
            r, j = x, y
            factor = A[r][j]
            A[r] = [v / factor for v in A[r]]
            snapshot("N", r"Normalizace pivotního řádku %s" % (r + 1))
        elif code == EV_ELIM_BELOW:
            j, r = x, y
            for k in range(r + 1, len(A)):
                f = A[k][j]
                if f != 0:
                    A[k] = [a - f * b for a, b in zip(A[k], A[r])]
            snapshot(
                "E", r"Eliminace prvků pod pivotem ve sloupci %s" % (j + 1)
            )
        elif code == EV_ELIM_ABOVE:
            j, r = x, y
            for k in range(r):
                f = A[k][j]
                if f != 0:
                    A[k] = [a - f * b for a, b in zip(A[k], A[r])]
            snapshot("E", r"Eliminace nad pivotem ve sloupci %s" % (j + 1))
        else:
            raise ValueError(f"Unknown event code {code}")

    return A, snapshots, steps


def log_replayed_reduction(
    host_items: Sequence[Sequence[Any]],
    events,
    num_events: int,
    bar_col: Optional[int] = None,
    log_matrices: bool = True,
    log_steps: bool = True,
) -> List[List[Any]]:
    """Replay device events and emit the derivation into the active trace
    logger; returns the (exact) reduced matrix."""
    reduced, snapshots, steps = replay_rref_events(
        host_items, events, num_events, bar_col
    )
    n = len(host_items[0])
    elimination.log_row_reduction_progress(
        snapshots, steps, n, log_matrices, log_steps
    )
    return reduced


def replay_matches_exact(
    host_items: Sequence[Sequence[Any]],
    events,
    num_events: int,
    bar_col: Optional[int] = None,
) -> bool:
    """Whether the replayed derivation's text equals the exact path's
    (``elimination.row_reduce`` on the same exact rows, logged the same
    way): the device chose the exact path's pivots and steps."""
    exact = _to_exact(host_items)
    n = len(exact[0])
    _, _, snapshots, steps = elimination.row_reduce(exact, bar_col=bar_col)
    want = capture_logs(lambda: elimination.log_row_reduction_progress(
        snapshots, steps, n, True, True))
    got = capture_logs(lambda: log_replayed_reduction(
        host_items, events, num_events, bar_col))
    return got == want


def replay_solve_trace(
    batch: int = 4,
    n: int = 3,
    seed: int = 0,
    device=None,
    systems=None,
) -> None:
    """Solve a small batch of ``A x = b`` on the device, then narrate batch
    element 0's derivation from its event stream, with the batch's exact
    integer determinants.

    The batch is drawn on ``device`` (``"cuda"`` unless the caller passes
    another) from ``seed``: regular integer A and integer b in [-5, 5]; or
    it is ``systems = (A [B, n, n], b [B, n])`` (numpy or tensors), so that
    a caller can give two implementations the same systems.  The text names
    where the batch was solved (``GPU`` on a CUDA device, else ``CPU``)."""
    from ..ops.exact_int import bareiss_batched
    from ..ops.generate import full_rank_batch, random_batch
    from ..ops.rref import rref_batched

    device = torch.device("cuda" if device is None else device)
    if systems is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        A = full_rank_batch(gen, batch, n, lo=-5, hi=5, device=device)
        b = random_batch(gen, batch, n, 1, device=device)[:, :, 0]
    else:
        A, b = (torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                device=device) for x in systems)
        batch, n = A.shape[0], A.shape[1]
    aug = torch.cat([A, b[:, :, None]], dim=2)
    res = rref_batched(aug, bar_col=n, tol=REPLAY_TOL)

    where = "GPU" if device.type == "cuda" else "CPU"
    log(
        r"Dávka %s soustav $A\,x=b$ řešena na " + where + r"; derivace "
        r"prvku 0 (přehrána z událostí zaznamenaných kernelem):",
        batch,
    )
    reduced_exact = log_replayed_reduction(
        aug[0].cpu().numpy(),
        res.events[0].cpu().numpy(),
        int(res.num_events[0]),
        bar_col=n,
    )
    log(
        r"Řešení prvku 0 (přesně, z přehrané derivace): "
        r"$x = \left(%s\right)$",
        ", ".join(cformat(row[n]) for row in reduced_exact),
    )

    # Exact integer determinants of the same batch (Bareiss, bit-exact).
    bres = bareiss_batched(torch.round(A).to(torch.int32))
    log(
        r"Celočíselné determinanty dávky (Bareissova eliminace, přesně): "
        r"$%s$",
        ", ".join(str(int(d)) for d in bres.det.cpu()),
    )
