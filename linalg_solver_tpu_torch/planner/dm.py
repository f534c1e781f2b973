"""Dulmage–Mendelsohn decomposition of a sparsity pattern.

Produces row/column permutations bringing the pattern into upper
block-triangular form, plus the diagonal block sizes:

1. Maximum matching (Hopcroft–Karp).
2. Coarse partition: H = reachable from unmatched rows by alternating
   paths; V = can reach unmatched columns; S = the rest (square part).
3. Fine decomposition of S: Tarjan SCCs of the matching-contracted digraph,
   reversed so blocks come out in upper-triangular order.
4. Block-order normalization: when the matrix is block *diagonal* (no
   inter-block edges) blocks are sorted by minimal original row, minimizing
   the permutations that later show up in the LaTeX derivation.

Structurally singular patterns (unequal H/V sides, zero rows/cols) return a
trivial single-block result that callers skip.

Mirrors linalg-solver's linalg-helper/src/dm.rs:75-386.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, Set, Tuple

from ..exact.permutation import Permutation
from .graphs import hopcroft_karp, tarjan_scc
from .pattern import Matching, SparsityPattern

BlockPairs = List[Tuple[int, int]]  # (original_row, matched_col) per position


@dataclass
class DMResult:
    row_perm: Permutation
    col_perm: Permutation
    block_sizes: List[int]

    @property
    def is_decomposable(self) -> bool:
        return len(self.block_sizes) > 1

    def __repr__(self) -> str:
        return (
            f"DMResult(row_perm={self.row_perm.perm}, "
            f"col_perm={self.col_perm.perm}, block_sizes={self.block_sizes})"
        )


def _alternating_reach_from_unmatched_rows(
    pattern: SparsityPattern, matching: Matching
) -> Tuple[Set[int], Set[int]]:
    """H partition: BFS from unmatched rows; rows leave via any edge, columns
    return only via their matching edge."""
    h_rows: Set[int] = set()
    h_cols: Set[int] = set()
    queue: deque = deque()
    for r in range(pattern.rows):
        if matching.row_to_col[r] is None:
            h_rows.add(r)
            queue.append((r, True))
    while queue:
        v, is_row = queue.popleft()
        if is_row:
            for c in pattern.row_neighbors(v):
                if c not in h_cols:
                    h_cols.add(c)
                    queue.append((c, False))
        else:
            r = matching.col_to_row[v]
            if r is not None and r not in h_rows:
                h_rows.add(r)
                queue.append((r, True))
    return h_rows, h_cols


def _alternating_reach_to_unmatched_cols(
    pattern: SparsityPattern, matching: Matching
) -> Tuple[Set[int], Set[int]]:
    """V partition: reverse BFS from unmatched columns."""
    v_rows: Set[int] = set()
    v_cols: Set[int] = set()
    queue: deque = deque()
    for c in range(pattern.cols):
        if matching.col_to_row[c] is None:
            v_cols.add(c)
            queue.append((c, False))
    while queue:
        v, is_row = queue.popleft()
        if not is_row:
            for r in pattern.col_neighbors(v):
                if r not in v_rows:
                    v_rows.add(r)
                    queue.append((r, True))
        else:
            c = matching.row_to_col[v]
            if c is not None and c not in v_cols:
                v_cols.add(c)
                queue.append((c, False))
    return v_rows, v_cols


def _trivial(rows: int, cols: int) -> DMResult:
    return DMResult(
        Permutation.id(rows), Permutation.id(cols), [rows]
    )


def dulmage_mendelsohn(pattern: SparsityPattern) -> DMResult:
    rows, cols = pattern.rows, pattern.cols
    if rows == 0 or cols == 0:
        return DMResult(Permutation.id(rows), Permutation.id(cols), [])

    matching = hopcroft_karp(pattern)
    h_rows, h_cols = _alternating_reach_from_unmatched_rows(pattern, matching)
    v_rows, v_cols = _alternating_reach_to_unmatched_cols(pattern, matching)

    s_rows = [
        r for r in range(rows) if r not in h_rows and r not in v_rows
    ]
    s_cols_set = {
        c for c in range(cols) if c not in h_cols and c not in v_cols
    }

    # Digraph on the square part: edge i -> j iff row s_rows[i] touches the
    # column matched to row s_rows[j].
    s_index = {r: i for i, r in enumerate(s_rows)}
    s_adj: List[List[int]] = [[] for _ in s_rows]
    for i, r in enumerate(s_rows):
        for c in pattern.row_neighbors(r):
            if c in s_cols_set:
                matched_r = matching.col_to_row[c]
                if matched_r is not None:
                    j = s_index.get(matched_r)
                    if j is not None and j != i:
                        s_adj[i].append(j)

    sccs = tarjan_scc(s_adj)

    blocks: List[Tuple[BlockPairs, int]] = []

    # H partition first (it can only feed into later blocks).
    hr, hc = sorted(h_rows), sorted(h_cols)
    if hr or hc:
        if len(hr) != len(hc):
            return _trivial(rows, cols)  # structurally singular
        pairs = list(zip(hr, hc))
        blocks.append((pairs, min(r for r, _ in pairs)))

    # Square part: SCCs reversed (sinks-first -> sources-first) gives upper
    # block-triangular order; sort rows inside each block.
    for scc in reversed(sccs):
        pairs = []
        for idx in scc:
            r = s_rows[idx]
            c = matching.row_to_col[r]
            if c is not None:
                pairs.append((r, c))
        if not pairs:
            continue
        pairs.sort(key=lambda rc: rc[0])
        blocks.append((pairs, pairs[0][0]))

    # V partition last.
    vr, vc = sorted(v_rows), sorted(v_cols)
    if vr or vc:
        if len(vr) != len(vc):
            return _trivial(rows, cols)
        pairs = list(zip(vr, vc))
        blocks.append((pairs, min(r for r, _ in pairs)))

    blocks = _normalize_block_order(pattern, blocks)

    row_perm_vec: List[int] = []
    col_perm_vec: List[int] = []
    block_sizes: List[int] = []
    for pairs, _ in blocks:
        if not pairs:
            continue
        block_sizes.append(len(pairs))
        for r, c in pairs:
            row_perm_vec.append(r)
            col_perm_vec.append(c)

    if len(row_perm_vec) != rows or len(col_perm_vec) != cols:
        return _trivial(rows, cols)  # zero rows/cols etc.

    return DMResult(
        Permutation(row_perm_vec, _validate=False),
        Permutation(col_perm_vec, _validate=False),
        block_sizes,
    )


def _normalize_block_order(
    pattern: SparsityPattern, blocks: List[Tuple[BlockPairs, int]]
) -> List[Tuple[BlockPairs, int]]:
    """If the pattern is block *diagonal* (no edges between different blocks),
    reorder blocks by their minimal original row to minimize permutation
    churn; otherwise keep the topological order."""
    if len(blocks) <= 1:
        return blocks
    block_cols = [
        {c for _, c in pairs} for pairs, _ in blocks
    ]
    block_rows = [
        {r for r, _ in pairs} for pairs, _ in blocks
    ]
    n = len(blocks)
    for i in range(n):
        for r in block_rows[i]:
            for c in pattern.row_neighbors(r):
                for j in range(n):
                    if j != i and c in block_cols[j]:
                        return blocks  # inter-block edge: keep topo order
    return sorted(blocks, key=lambda b: b[1])
