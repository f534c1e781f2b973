"""Admissible lower bound for the determinant-strategy search.

``det(P)`` expands to a sum of SIGNED PERMUTATION MONOMIALS; distinct
monomials can never cancel (each is a distinct product of variables
with a ±1 coefficient), so the determinant — as a polynomial —
depends on exactly the entries that lie on at least one perfect
matching of the sparsity pattern ("influential" entries).  Any
straight-line computation of a function of ``m`` independent variables
performs at least ``m − 1`` binary operations, and the planner's cost
model counts every multiplication/addition except sign flips (which
combine nothing), so

    cost(P)  ≥  (#influential entries) − 1        (perfect matching)
    cost(P)  ≥  0                                 (structurally singular)

is an ADMISSIBLE bound: branch-and-bound pruning against it returns
exactly the exhaustive search's optimum (tests assert equality on all
small patterns).  Influential-entry detection is the classical
alternating-cycle characterization: with a perfect matching M, entry
``(r, c) ∉ M`` is on some perfect matching iff ``r`` and ``M⁻¹(c)``
lie in the same SCC of the matching digraph (rows as vertices, edges
``r → M⁻¹(c)`` for each nonzero ``(r, c)``).

Cost-model contract per linalg-solver's linalg-helper/src/
determinant.rs:553-563; the bound itself has no reference counterpart
(the reference's search is purely exhaustive, determinant.rs:575-665).
"""

from __future__ import annotations

from .graphs import hopcroft_karp, tarjan_scc
from .pattern import SparsityPattern


def influential_lower_bound(pattern: SparsityPattern) -> int:
    """Admissible lower bound on ``Cost.total`` for ``pattern``."""
    n = pattern.rows
    if n != pattern.cols or n <= 1:
        return 0
    match = hopcroft_karp(pattern)
    if match.size() < n:
        return 0  # det ≡ 0 structurally; a zero-cost plan may exist

    # Matching digraph on row vertices: r → M⁻¹(c) for every nonzero
    # (r, c) with c not matched to r.
    adj: list[list[int]] = [[] for _ in range(n)]
    for r in range(n):
        mc = match.row_to_col[r]
        for c in pattern.row_neighbors(r):
            if c != mc:
                adj[r].append(match.col_to_row[c])

    scc_id = [0] * n
    for i, comp in enumerate(tarjan_scc(adj)):
        for v in comp:
            scc_id[v] = i

    influential = 0
    for r in range(n):
        mc = match.row_to_col[r]
        for c in pattern.row_neighbors(r):
            if c == mc or scc_id[r] == scc_id[match.col_to_row[c]]:
                influential += 1
    return max(influential - 1, 0)


def greedy_upper_bound(
    pattern: SparsityPattern, memo: dict | None = None
) -> int:
    """Cheap upper bound on the optimal ``Cost.total``: the cost of
    one concrete strategy — Dulmage–Mendelsohn block-triangularization
    when it splits, else Laplace expansion along the minimum-nnz row,
    recursing greedily.  Since this IS one of the search's candidate
    strategies (continued suboptimally), the optimum is ≤ it, so the
    search may prune any candidate proved > it (threshold
    ``greedy + 1``) without losing exactness or tie order.  Memoized
    on exact pattern bits (minors recur heavily)."""
    from .dm import dulmage_mendelsohn

    if memo is None:
        memo = {}
    n = pattern.rows
    if n <= 1:
        return 0
    if n == 2:
        # The search charges Cost.direct(2) = 3 for EVERY 2×2 (even
        # sparse ones) — returning less would under-run the optimum
        # and make greedy-threshold pruning inexact.
        return 3
    key = pattern.key()
    hit = memo.get(key)
    if hit is not None:
        return hit
    memo[key] = _direct_total(n)  # cycle guard (unused paths)

    dm = dulmage_mendelsohn(pattern)
    if len(dm.block_sizes) > 1:
        total = len(dm.block_sizes) - 1
        offset = 0
        for bs in dm.block_sizes:
            rows = dm.row_perm.perm[offset:offset + bs]
            cols = dm.col_perm.perm[offset:offset + bs]
            total += greedy_upper_bound(
                pattern.submatrix(rows, cols), memo
            )
            offset += bs
        memo[key] = total
        return total

    row = min(range(n), key=pattern.row_nnz)
    nonzero_cols = pattern.row_neighbors(row)
    if not nonzero_cols:
        memo[key] = 0
        return 0
    k = len(nonzero_cols)
    total = 2 * k - 1
    remaining_rows = [r for r in range(n) if r != row]
    for col in nonzero_cols:
        remaining_cols = [c for c in range(n) if c != col]
        total += greedy_upper_bound(
            pattern.submatrix(remaining_rows, remaining_cols), memo
        )
    memo[key] = total
    return total


def _direct_total(n: int) -> int:
    import math

    if n <= 1:
        return 0
    if n == 2:
        return 3
    f = math.factorial(n)
    return f * (n - 1) + f - 1
