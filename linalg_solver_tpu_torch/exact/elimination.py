"""Exact Gauss–Jordan elimination engine with step tracing (counterpart of
``linalg_solver_tpu.exact.elimination``).

Works on plain lists-of-lists of exact scalars (ints, ``Fraction``,
``Polynomial``).  Produces the reduced matrix, pivot positions, and the
intermediate LaTeX snapshots + step descriptions used by the trace layer.

Step labels: ``S<k>`` row swap, ``N<k>`` pivot normalization, ``E<k>``
elimination.  The pivot rule is **first nonzero row at or below the pivot
row** — the rule of ``ops.rref``'s ``pivot_rule="first"``, whose recorded
events ``trace.events`` replays into the same text.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, List, Optional, Tuple

from ..utils.fmt import (
    make_latex_augmented_matrix,
    make_latex_vector,
    make_latex_vertical_augmented_matrix,
)
from ..utils.trace import log

Items = List[List[Any]]
Pivots = List[Tuple[int, int]]
Steps = List[Tuple[str, str]]


def row_reduce(
    items: Items, bar_col: Optional[int] = None
) -> Tuple[Items, Pivots, List[str], Steps]:
    """Full Gauss–Jordan on an augmented matrix.

    Eliminates only in columns ``< bar_col``; columns at/after the bar are
    transformed along but never pivoted on.  Returns
    ``(reduced, pivots, intermediate_matrices_latex, intermediate_steps)``.
    """
    A = deepcopy(items)
    m, n = len(A), len(A[0])
    bar_col = bar_col if bar_col is not None else n - 1

    snapshots = [make_latex_augmented_matrix(A, bar_col=bar_col)]
    steps: Steps = []
    pivots: Pivots = []
    step_no = 0

    def snapshot(label_prefix: str, description: str) -> None:
        nonlocal step_no
        snapshots.append(make_latex_augmented_matrix(A, bar_col=bar_col))
        steps.append((f"{label_prefix}{step_no}", description))
        step_no += 1

    pi, pj = 0, 0
    while pi < m and pj < bar_col:
        # Pivot selection: first nonzero row at-or-below pi in column pj.
        if A[pi][pj] == 0:
            swap_row = next(
                (i for i in range(pi + 1, m) if A[i][pj] != 0), None
            )
            if swap_row is None:
                pj += 1
                continue
            A[pi], A[swap_row] = A[swap_row], A[pi]
            snapshot(
                "S",
                r"Výměna řádků $R_{%d}$ a $R_{%d}$" % (pi + 1, swap_row + 1),
            )

        # Normalize the pivot row to a unit pivot.
        factor = A[pi][pj]
        changed = False
        if factor != 1:
            for j in range(pj, n):
                new_val = A[pi][j] / factor
                changed = changed or new_val != A[pi][j]
                A[pi][j] = new_val
        if changed:
            snapshot("N", r"Normalizace pivotního řádku %s" % (pi + 1))

        # Eliminate entries below the pivot.
        changed = False
        touched = False
        for k in range(pi + 1, m):
            f = A[k][pj]
            if f == 0:
                continue
            touched = True
            for j in range(pj, n):
                new_val = A[k][j] - f * A[pi][j]
                changed = changed or new_val != A[k][j]
                A[k][j] = new_val
        if touched and changed:
            snapshot(
                "E", r"Eliminace prvků pod pivotem ve sloupci %s" % (pj + 1)
            )

        pivots.append((pi, pj))
        pi += 1
        pj += 1

    # Back-substitution: eliminate above each pivot, last pivot first.
    for row, col in reversed(pivots):
        changed = False
        for k in range(row):
            f = A[k][col]
            if f == 0:
                continue
            for j in range(col, n):
                new_val = A[k][j] - f * A[row][j]
                changed = changed or new_val != A[k][j]
                A[k][j] = new_val
        if changed:
            snapshot("E", r"Eliminace nad pivotem ve sloupci %s" % (col + 1))

    return A, pivots, snapshots, steps


def check_inconsistency(
    reduced: Items, n: int, bar_col: int, log_fn: Optional[Callable] = None
) -> bool:
    """True iff some row is zero on the left of the bar but nonzero at it."""
    for i, row in enumerate(reduced):
        if all(row[j] == 0 for j in range(n)) and row[bar_col] != 0:
            if log_fn:
                log_fn(
                    r"\textbf{Nalezen nekonzistentní řádek (řádek %s):} $ %s $",
                    i + 1,
                    make_latex_augmented_matrix([row], bar_col=bar_col),
                )
                log_fn(
                    r"\[ \boxed{\text{Systém je nekonzistentní: žádné řešení.}} \]"
                )
            return True
    return False


def extract_affine_subspace(
    reduced: Items,
    pivots: Pivots,
    n: int,
    bar_col: int,
    log_fn: Optional[Callable] = None,
):
    """From an RREF-ed augmented matrix, build the particular solution and
    one nullspace generator per free variable.

    Returns ``(particular: List, generators_columns: List[List] | None)``
    where generators_columns is a list-of-rows matrix whose columns are the
    generators (or None when the solution is unique).
    """
    m = len(reduced)
    pivot_col_of_row = [-1] * m
    pivot_cols = set()
    for row, col in pivots:
        pivot_col_of_row[row] = col
        pivot_cols.add(col)
    free_vars = [j for j in range(n) if j not in pivot_cols]

    if log_fn:
        log_fn(
            r"\textbf{Pivotní sloupce:} $ %s$ \\",
            ", ".join("x_{%d}" % (j + 1) for j in sorted(pivot_cols)),
        )
        log_fn(
            r"\textbf{Volné proměnné:} $ %s$ \\",
            ", ".join("x_{%d}" % (j + 1) for j in free_vars),
        )

    # Particular solution: free variables fixed to zero.
    particular: List[Any] = [0] * n
    for i in range(m):
        col = pivot_col_of_row[i]
        if col != -1:
            particular[col] = reduced[i][bar_col]
    if log_fn:
        log_fn(
            r"\textbf{Partikulární řešení (volné proměnné = 0):} $ %s $ \\",
            make_latex_vector(particular),
        )

    # One homogeneous generator per free variable.
    generators: List[List[Any]] = []
    for free_j in free_vars:
        gen: List[Any] = [0] * n
        gen[free_j] = 1
        for i in range(m):
            col = pivot_col_of_row[i]
            if col != -1:
                gen[col] = -reduced[i][free_j]
        generators.append(gen)

    if not generators:
        return particular, None

    gen_columns = [list(col) for col in zip(*generators)]
    if log_fn:
        header = " & ".join("x_{%d}" % (fv + 1) for fv in free_vars)
        log_fn(
            r"\textbf{Báze jádra (sloupce jsou vektory pro volné proměnné "
            r"$x_i$):} \[ %s \]",
            make_latex_vertical_augmented_matrix(
                header, gen_columns, len(generators)
            ),
        )
    return particular, gen_columns


def log_row_reduction_progress(
    snapshots: List[str],
    steps: Steps,
    num_augmented_cols: int,
    log_matrices: bool,
    log_steps: bool,
) -> None:
    """Emit the chain of intermediate matrices joined by ``\\sim`` /
    ``\\StepSim{label}``, wrapped into lines, then an itemized step list."""
    if not log_matrices and not log_steps:
        return

    MAX_LINE_WIDTH = 10
    width_estimate = num_augmented_cols if num_augmented_cols > 0 else 11

    def emit_step_list() -> None:
        if not (log_steps and steps):
            return
        log(r"\begin{itemize}[noitemsep,topsep=0pt,parsep=0pt,partopsep=0pt]")
        for label, desc in steps:
            log(r"\item \textbf{%s}: %s" % (label, desc))
        log(r"\end{itemize}")

    if not (log_matrices and snapshots):
        emit_step_list()
        return

    log(r"Mezikroky:")
    # Decide after which snapshot indices to break the line.
    breaks = set()
    width, count = 0, 0
    for idx in range(len(snapshots)):
        if count > 0 and width + width_estimate > MAX_LINE_WIDTH:
            breaks.add(idx - 1)
            width, count = 0, 0
        width += width_estimate
        count += 1

    parts = [r"\begin{align*}" + "\n"]
    for i, snap in enumerate(snapshots):
        prefix = "&" if i == 0 or (i - 1) in breaks else ""
        parts.append(prefix + snap)
        if i < len(snapshots) - 1:
            if log_steps and 0 <= i < len(steps):
                parts.append(r" \StepSim{%s} " % steps[i][0].strip())
            else:
                parts.append(r" \sim ")
            if i in breaks:
                parts.append(r" \\")
            parts.append("\n")
    parts.append("\n" + r"\end{align*}")
    log("".join(parts))

    if log_steps and steps:
        log(r"Provedené kroky:")
        emit_step_list()
