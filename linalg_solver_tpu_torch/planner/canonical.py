"""Canonicalization of sparsity patterns under row/column permutation.

Finds permutations P, Q such that C = P·X·Q is a canonical representative:
any two permutation-equivalent patterns map to the same C.  Used as the
cache key of the planner's search so that permuted subproblems share work.

Method: Weisfeiler–Lehman color refinement on the bipartite row/column
graph (initial colors = degrees, refine with sorted neighbor-color
multisets until stable), then lexicographic tie-breaking inside each color
class using row/column incidence bitstrings, with an extra stabilization
pass; finally a 64-bit FNV-1a hash over the canonically-ordered pattern.

Mirrors linalg-solver's linalg-helper/src/canonical.rs:83-283.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..exact.permutation import Permutation
from .pattern import SparsityPattern


@dataclass
class CanonicalForm:
    #: canonical_row[i] = original_row[row_perm[i]]
    row_perm: Permutation
    col_perm: Permutation
    canonical_hash: int

    def __repr__(self) -> str:
        return (
            f"CanonicalForm(row_perm={self.row_perm.perm}, "
            f"col_perm={self.col_perm.perm}, "
            f"hash={self.canonical_hash:#x})"
        )


def _wl_refine(
    pattern: SparsityPattern,
) -> Tuple[List[List[int]], List[List[int]]]:
    """Refine row/column colors to stability; return the stable partitions
    (lists of index groups, ordered by color)."""
    n_rows, n_cols = pattern.rows, pattern.cols
    if n_rows == 0 or n_cols == 0:
        return [], []

    row_colors: List[tuple] = [(pattern.row_nnz(r),) for r in range(n_rows)]
    col_colors: List[tuple] = [(pattern.col_nnz(c),) for c in range(n_cols)]

    for _ in range(n_rows + n_cols):
        row_ids = _compress(row_colors)
        col_ids = _compress(col_colors)
        new_row_colors = [
            (row_ids[r],)
            + tuple(sorted(col_ids[c] for c in pattern.row_neighbors(r)))
            for r in range(n_rows)
        ]
        new_col_colors = [
            (col_ids[c],)
            + tuple(sorted(row_ids[r] for r in pattern.col_neighbors(c)))
            for c in range(n_cols)
        ]
        if new_row_colors == row_colors and new_col_colors == col_colors:
            break
        row_colors, col_colors = new_row_colors, new_col_colors

    return _group_by_color(row_colors), _group_by_color(col_colors)


def _compress(colors: List[tuple]) -> List[int]:
    """Map each color to its rank among the distinct sorted colors."""
    ranking = {c: i for i, c in enumerate(sorted(set(colors)))}
    return [ranking[c] for c in colors]


def _group_by_color(colors: List[tuple]) -> List[List[int]]:
    groups: dict = {}
    for idx, color in enumerate(colors):
        groups.setdefault(color, []).append(idx)
    return [groups[c] for c in sorted(groups)]


def _row_signature(pattern: SparsityPattern, r: int,
                   col_order: List[int]) -> Tuple[bool, ...]:
    return tuple(pattern.get(r, c) for c in col_order)


def _col_signature(pattern: SparsityPattern, c: int,
                   row_order: List[int]) -> Tuple[bool, ...]:
    return tuple(pattern.get(r, c) for r in row_order)


def canonicalize(pattern: SparsityPattern) -> CanonicalForm:
    n_rows, n_cols = pattern.rows, pattern.cols
    if n_rows == 0 or n_cols == 0:
        return CanonicalForm(
            Permutation.id(n_rows), Permutation.id(n_cols), 0
        )

    row_parts, col_parts = _wl_refine(pattern)

    # Preliminary column order: partitions in color order, indices as-is.
    col_order: List[int] = [c for part in col_parts for c in part]

    # Rows: lexicographic within partitions against the column order.
    row_order: List[int] = []
    for part in row_parts:
        row_order.extend(
            sorted(part, key=lambda r: _row_signature(pattern, r, col_order))
        )

    # Columns: re-order against the new row order.
    col_order = []
    for part in col_parts:
        col_order.extend(
            sorted(part, key=lambda c: _col_signature(pattern, c, row_order))
        )

    # One more row pass to stabilize.
    row_order = []
    for part in row_parts:
        row_order.extend(
            sorted(part, key=lambda r: _row_signature(pattern, r, col_order))
        )

    return CanonicalForm(
        Permutation(row_order, _validate=False),
        Permutation(col_order, _validate=False),
        _pattern_hash(pattern, row_order, col_order),
    )


def _pattern_hash(pattern: SparsityPattern, row_order: List[int],
                  col_order: List[int]) -> int:
    """64-bit FNV-1a over dimensions + canonically ordered bits."""
    h = 0xCBF29CE484222325
    FNV_PRIME = 0x100000001B3
    MASK = (1 << 64) - 1

    def mix(byte: int) -> None:
        nonlocal h
        h = ((h ^ byte) * FNV_PRIME) & MASK

    for dim in (pattern.rows, pattern.cols):
        for shift in range(0, 64, 8):
            mix((dim >> shift) & 0xFF)
    acc = 0
    nbits = 0
    for r in row_order:
        for c in col_order:
            acc = (acc << 1) | (1 if pattern.get(r, c) else 0)
            nbits += 1
            if nbits == 8:
                mix(acc)
                acc, nbits = 0, 0
    if nbits:
        mix(acc << (8 - nbits))
    return h


def are_permutation_equivalent(a: SparsityPattern,
                               b: SparsityPattern) -> bool:
    """True iff P·A·Q = B for some permutation matrices P, Q.

    Hash equality is verified against the actual canonical forms to guard
    hash collisions.
    """
    if a.rows != b.rows or a.cols != b.cols:
        return False
    ca = canonicalize(a)
    cb = canonicalize(b)
    if ca.canonical_hash != cb.canonical_hash:
        return False
    for i in range(a.rows):
        for j in range(a.cols):
            if a.get(ca.row_perm[i], ca.col_perm[j]) != b.get(
                cb.row_perm[i], cb.col_perm[j]
            ):
                return False
    return True
