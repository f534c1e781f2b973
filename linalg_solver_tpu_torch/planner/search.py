"""Optimal determinant-strategy search: branch-and-bound DFS.

DFS over sparsity patterns trying, in order: block-triangular
decomposition (Dulmage–Mendelsohn), Laplace expansion along every row,
along every column, and every determinant-preserving AddRow elimination
that strictly reduces the nonzero count.  Results are memoized under
the WL-canonical hash of the pattern, with processes stored in
canonical coordinates and remapped on retrieval — permutation-
equivalent subproblems share one cache entry.  A direct-cost sentinel
guards recursion cycles through AddRow.

BRANCH AND BOUND (exact — provably the same optimum and the same
first-found-among-ties process tree as the exhaustive search, which is
kept behind ``prune=False`` for differential testing):

- every recursion carries a ``budget``: the candidate under evaluation
  cannot win unless this subproblem costs strictly less.  A subsearch
  that proves its optimum ≥ budget returns a LOWER BOUND instead of a
  process; the candidate is abandoned (exactly when it would have lost
  the strict-< tie anyway, so the returned plan is bit-identical).
- the admissible static bound is ``influential_lower_bound``
  (planner/bound.py): det(P) depends on exactly the entries lying on
  some perfect matching, so any strategy costs ≥ (#influential − 1).
- cache entries carry an ``exact`` flag: bound-limited results cache
  their best-proved lower bound and are re-searched only if a later
  query arrives with a larger budget.

SwapRows is deliberately not a strategy: a swapped pattern is
permutation-equivalent, hits the same cache entry, and costs the same.

Mirrors linalg-solver's linalg-helper/src/determinant.rs:553-967; the
cost model is the contract (direct: n!(n-1) mults + (n!-1) adds;
expansion with k nonzeros: k mults + (k-1) adds; AddRow: (src_nnz-1)
mults + overlap adds; block combine: (b-1) mults).  The bound /
budget machinery has no reference counterpart (the reference search
is purely exhaustive).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .bound import influential_lower_bound
from .canonical import canonicalize
from .dm import dulmage_mendelsohn
from .pattern import SparsityPattern
from .process import (
    AddRow,
    BlockTriangular,
    ColExpansion,
    Cost,
    Direct,
    Nonzeros,
    Process,
    RowExpansion,
    canonicalize_process,
    remap_process,
)

_INF = 1 << 62

#: cache value: (cost, proc_in_canonical_coords, exact, lower_bound).
#: exact entries hold the proven optimum; non-exact entries hold the
#: best lower bound proved so far (proc is None).
ProcessCache = Dict[int, Tuple[Cost, Optional[Process], bool, int]]

#: search result: (cost, proc, exact).  Non-exact results carry the
#: proved lower bound in ``cost`` (as ``Cost(lb, 0)``) and ``proc``
#: is None — valid only as evidence that the optimum is ≥ budget.
_Result = Tuple[Cost, Optional[Process], bool]


def _pattern_nonzeros(pattern: SparsityPattern) -> Nonzeros:
    return Nonzeros(pattern.rows, pattern.cols, pattern.nonzero_entries())


def find_optimal_process(
    pattern: SparsityPattern, prune: bool = True
) -> Tuple[Cost, Process]:
    """Entry point: plan the cheapest determinant strategy for
    ``pattern``.

    ``prune=True`` (default) enables the admissible branch-and-bound
    cuts — provably the same optimum (and process tree) as
    ``prune=False``, the pure exhaustive search kept for differential
    testing."""
    cache: ProcessCache = {}
    cost, proc, exact = _search(pattern, cache, prune, _INF)
    assert exact and proc is not None
    return cost, proc


def _search(
    pattern: SparsityPattern,
    cache: ProcessCache,
    prune: bool,
    budget: int,
) -> _Result:
    n = pattern.rows
    assert n == pattern.cols, "Matrix must be square"

    if n <= 2:
        return (
            Cost.direct(n),
            Process(Direct(n), _pattern_nonzeros(pattern)),
            True,
        )

    if _node_hook is not None:
        _node_hook()
    canon = canonicalize(pattern)
    cached = cache.get(canon.canonical_hash)
    if cached is not None:
        cost, proc, exact, lb = cached
        if exact:
            return (
                cost,
                remap_process(proc, canon.row_perm, canon.col_perm),
                True,
            )
        if lb >= budget:
            return (Cost(lb, 0), None, False)

    lb0 = 0
    if prune:
        lb0 = influential_lower_bound(pattern)
        if cached is not None:
            lb0 = max(lb0, cached[3])
        if lb0 >= budget:
            cache[canon.canonical_hash] = (Cost(lb0, 0), None, False, lb0)
            return (Cost(lb0, 0), None, False)

    # Sentinel: if the search re-enters this pattern (via AddRow
    # cycles), it sees the direct cost as an upper bound instead of
    # recursing forever.
    canonical_nz = _pattern_nonzeros(pattern).permute_inv(
        canon.row_perm, canon.col_perm
    )
    cache[canon.canonical_hash] = (
        Cost.direct(n),
        Process(Direct(n), canonical_nz),
        True,
        0,
    )

    best: Optional[Tuple[Cost, Process]] = None
    node_lb = _INF  # min over candidate lower bounds (all-pruned case)

    def ub() -> int:
        b = budget if prune else _INF
        if best is not None:
            b = min(b, best[0].total)
        return b

    def update_best(cost: Cost, process: Process) -> None:
        nonlocal best
        if best is None or cost.total < best[0].total:
            best = (cost, process)

    def note_lb(candidate_lb: int) -> None:
        nonlocal node_lb
        node_lb = min(node_lb, candidate_lb)

    nz = _pattern_nonzeros(pattern)

    # ---- Strategy 1: block triangular via DM -------------------------
    dm = dulmage_mendelsohn(pattern)
    if len(dm.block_sizes) > 1:
        immediate = len(dm.block_sizes) - 1
        total = Cost.zero()
        blocks: List[Process] = []
        offset = 0
        abandoned = False
        for block_size in dm.block_sizes:
            sub_budget = ub() - immediate - total.total
            if prune and sub_budget <= 0:
                note_lb(immediate + total.total)
                abandoned = True
                break
            block_rows = dm.row_perm.perm[offset:offset + block_size]
            block_cols = dm.col_perm.perm[offset:offset + block_size]
            sub = pattern.submatrix(block_rows, block_cols)
            sc, sp, exact = _search(sub, cache, prune, sub_budget)
            if not exact:
                note_lb(immediate + total.total + sc.total)
                abandoned = True
                break
            total = total + sc
            blocks.append(sp)
            offset += block_size
        if not abandoned:
            total = total.add_mults(immediate)
            update_best(
                total,
                Process(
                    BlockTriangular(blocks, dm.row_perm, dm.col_perm),
                    nz,
                ),
            )

    # ---- Strategies 2/3: row and column expansions --------------------
    for axis in (0, 1):
        for line in range(n):
            nonzeros = (
                pattern.row_neighbors(line) if axis == 0
                else pattern.col_neighbors(line)
            )
            if not nonzeros:
                # Zero line: determinant trivially 0, no work at all.
                update_best(Cost.zero(), Process(Direct(n), nz))
                continue
            k = len(nonzeros)
            immediate = 2 * k - 1        # k mults + (k−1) adds
            total = Cost.zero()
            minors: List[Tuple[int, Process]] = []
            abandoned = False
            for crossing in nonzeros:
                sub_budget = ub() - immediate - total.total
                if prune and sub_budget <= 0:
                    note_lb(immediate + total.total)
                    abandoned = True
                    break
                if axis == 0:
                    rs = [r for r in range(n) if r != line]
                    cs = [c for c in range(n) if c != crossing]
                else:
                    rs = [r for r in range(n) if r != crossing]
                    cs = [c for c in range(n) if c != line]
                sub = pattern.submatrix(rs, cs)
                sc, sp, exact = _search(sub, cache, prune, sub_budget)
                if not exact:
                    note_lb(immediate + total.total + sc.total)
                    abandoned = True
                    break
                total = total + sc
                minors.append((crossing, sp))
            if abandoned:
                continue
            total = total.add_mults(k)
            if k > 1:
                total = total.add_adds(k - 1)
            raw = (
                RowExpansion(line, minors) if axis == 0
                else ColExpansion(line, minors)
            )
            update_best(total, Process(raw, nz))

    # ---- Strategy 4: AddRow eliminations ------------------------------
    nnz_before = pattern.total_nnz()
    for src in range(n):
        src_nnz = pattern.row_nnz(src)
        src_mask = pattern.row_mask(src)
        for dst in range(n):
            if src == dst:
                continue
            dst_mask = pattern.row_mask(dst)
            both = src_mask & dst_mask
            while both:
                low = both & -both
                pivot_col = low.bit_length() - 1
                both ^= low

                modified = pattern.with_add_row(src, dst, pivot_col)
                if modified.total_nnz() >= nnz_before:
                    continue  # the operation must strictly help

                overlap = (
                    (src_mask & dst_mask & ~(1 << pivot_col)).bit_count()
                )
                op_cost = Cost(src_nnz - 1, overlap)
                sub_budget = ub() - op_cost.total
                if prune:
                    # Static bound first: skip without recursing.
                    mod_lb = influential_lower_bound(modified)
                    if op_cost.total + mod_lb >= ub():
                        note_lb(op_cost.total + mod_lb)
                        continue
                sc, sp, exact = _search(
                    modified, cache, prune, sub_budget
                )
                if not exact:
                    note_lb(op_cost.total + sc.total)
                    continue
                update_best(
                    op_cost + sc,
                    Process(AddRow(src, dst, pivot_col, sp), nz),
                )

    if best is not None and (not prune or best[0].total < budget):
        cache[canon.canonical_hash] = (
            best[0],
            canonicalize_process(best[1], canon.row_perm, canon.col_perm),
            True,
            best[0].total,
        )
        return (best[0], best[1], True)

    if best is None and node_lb >= _INF:
        # No strategy applies at all: fall back to direct evaluation
        # (always valid), exactly like the exhaustive search.
        result = (Cost.direct(n), Process(Direct(n), nz))
        cache[canon.canonical_hash] = (
            result[0],
            canonicalize_process(result[1], canon.row_perm,
                                 canon.col_perm),
            True,
            result[0].total,
        )
        return (result[0], result[1], True)

    # Bound-limited: every candidate was proved ≥ budget (a found-but-
    # too-expensive best is itself a valid lower bound witness).
    lb = node_lb if best is None else min(node_lb, best[0].total)
    lb = max(lb, lb0)
    cache[canon.canonical_hash] = (Cost(lb, 0), None, False, lb)
    return (Cost(lb, 0), None, False)


#: optional per-node callback installed by plan_anytime (raises to
#: abort the search when its node cap is hit).
_node_hook = None


def plan_anytime(
    pattern: SparsityPattern, node_cap: int = 20000
):
    """ANYTIME planning for patterns beyond the exact search's reach
    (the exact optimum is a combinatorial search — half-dense 10×10
    patterns are out of reach for ANY exact engine, including the
    reference's): run the branch-and-bound until ``node_cap`` nodes
    have been expanded, then fall back to the GREEDY strategy tree
    (min-nnz-row expansion / DM splits — always a valid process) if no
    exact plan finished.

    Returns ``(cost, process, optimal, lower_bound)``:

    - ``optimal`` True: the search finished under the cap; ``cost`` is
      the proven optimum (identical to ``find_optimal_process``).
    - ``optimal`` False: ``process`` is the greedy plan and
      ``lower_bound ≤ optimum ≤ cost.total`` is an honest
      suboptimality certificate (``influential_lower_bound``).

    Python-engine extension (no native twin): the shared reference API
    surface stays engine-identical; this is the documented scaling
    escape hatch beyond it.
    """
    global _node_hook
    cache: ProcessCache = {}
    counter = [0]

    class _CapHit(Exception):
        pass

    def hook():
        counter[0] += 1
        if counter[0] > node_cap:
            raise _CapHit()

    lb = influential_lower_bound(pattern)
    prev = _node_hook
    try:
        _node_hook = hook
        cost, proc, exact = _search(pattern, cache, True, _INF)
        assert exact
        return (cost, proc, True, cost.total)
    except _CapHit:
        pass
    finally:
        _node_hook = prev

    cost, proc = _greedy_process(pattern, {})
    return (cost, proc, False, lb)


def _greedy_process(
    pattern: SparsityPattern, memo: dict
) -> Tuple[Cost, Process]:
    """The concrete strategy tree whose cost ``greedy_upper_bound``
    computes: DM block-triangularization when it splits, else Laplace
    expansion along the min-nnz row, recursed greedily.  Identical
    subpatterns share one subtree (the exact search shares subtrees
    through its cache the same way)."""
    n = pattern.rows
    nz = _pattern_nonzeros(pattern)
    if n <= 2:
        return Cost.direct(n), Process(Direct(n), nz)
    key = pattern.key()
    hit = memo.get(key)
    if hit is not None:
        return hit

    dm = dulmage_mendelsohn(pattern)
    if len(dm.block_sizes) > 1:
        total = Cost(len(dm.block_sizes) - 1, 0)
        blocks = []
        offset = 0
        for bs in dm.block_sizes:
            rows = dm.row_perm.perm[offset:offset + bs]
            cols = dm.col_perm.perm[offset:offset + bs]
            sc, sp = _greedy_process(pattern.submatrix(rows, cols), memo)
            total = total + sc
            blocks.append(sp)
            offset += bs
        out = (total, Process(
            BlockTriangular(blocks, dm.row_perm, dm.col_perm), nz
        ))
        memo[key] = out
        return out

    row = min(range(n), key=pattern.row_nnz)
    nonzero_cols = pattern.row_neighbors(row)
    if not nonzero_cols:
        out = (Cost.zero(), Process(Direct(n), nz))
        memo[key] = out
        return out
    k = len(nonzero_cols)
    total = Cost(k, k - 1 if k > 1 else 0)
    minors = []
    remaining_rows = [r for r in range(n) if r != row]
    for col in nonzero_cols:
        remaining_cols = [c for c in range(n) if c != col]
        sc, sp = _greedy_process(
            pattern.submatrix(remaining_rows, remaining_cols), memo
        )
        total = total + sc
        minors.append((col, sp))
    out = (total, Process(RowExpansion(row, minors), nz))
    memo[key] = out
    return out
