"""Boolean sparsity patterns backed by per-row integer bitmasks.

Python ints are arbitrary-precision, so each row is one int with bit ``c``
set iff entry ``(r, c)`` is structurally nonzero — giving O(1) row unions
for the symbolic AddRow update and cheap popcounts.

Mirrors the reference's AdjacencyMatrix/Nonzeros/BitList storage
(linalg-solver's linalg-helper/src/adjacency.rs:5-119,
 nonzeros.rs:10-121, bitlist.rs:8-79) in a Python-idiomatic form.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


class SparsityPattern:
    __slots__ = ("rows", "cols", "_row_bits")

    def __init__(self, rows: int, cols: int,
                 row_bits: Sequence[int] | None = None):
        self.rows = rows
        self.cols = cols
        self._row_bits: List[int] = (
            list(row_bits) if row_bits is not None else [0] * rows
        )

    @staticmethod
    def from_bools(matrix: Sequence[Sequence[bool]]) -> "SparsityPattern":
        rows = len(matrix)
        cols = len(matrix[0]) if rows else 0
        bits = []
        for row in matrix:
            b = 0
            for c, val in enumerate(row):
                if val:
                    b |= 1 << c
            bits.append(b)
        return SparsityPattern(rows, cols, bits)

    def get(self, r: int, c: int) -> bool:
        return bool((self._row_bits[r] >> c) & 1)

    def set(self, r: int, c: int, value: bool) -> None:
        if value:
            self._row_bits[r] |= 1 << c
        else:
            self._row_bits[r] &= ~(1 << c)

    def row_mask(self, r: int) -> int:
        return self._row_bits[r]

    def row_neighbors(self, r: int) -> List[int]:
        b = self._row_bits[r]
        out = []
        while b:
            low = b & -b
            out.append(low.bit_length() - 1)
            b ^= low
        return out

    def col_neighbors(self, c: int) -> List[int]:
        mask = 1 << c
        return [r for r in range(self.rows) if self._row_bits[r] & mask]

    def row_nnz(self, r: int) -> int:
        return self._row_bits[r].bit_count()

    def col_nnz(self, c: int) -> int:
        mask = 1 << c
        return sum(1 for r in range(self.rows) if self._row_bits[r] & mask)

    def total_nnz(self) -> int:
        return sum(b.bit_count() for b in self._row_bits)

    def submatrix(self, row_indices: Sequence[int],
                  col_indices: Sequence[int]) -> "SparsityPattern":
        bits = []
        for old_r in row_indices:
            src = self._row_bits[old_r]
            b = 0
            for new_c, old_c in enumerate(col_indices):
                if (src >> old_c) & 1:
                    b |= 1 << new_c
            bits.append(b)
        return SparsityPattern(len(row_indices), len(col_indices), bits)

    def with_add_row(self, src: int, dst: int,
                     pivot_col: int) -> "SparsityPattern":
        """Symbolic effect of adding a multiple of ``src`` to ``dst`` chosen
        to zero out ``(dst, pivot_col)``: the dst row becomes the union of
        both rows minus the pivot bit."""
        bits = list(self._row_bits)
        bits[dst] = (bits[dst] | bits[src]) & ~(1 << pivot_col)
        return SparsityPattern(self.rows, self.cols, bits)

    def nonzero_entries(self) -> List[Tuple[int, int]]:
        return [
            (r, c)
            for r in range(self.rows)
            for c in self.row_neighbors(r)
        ]

    def to_bools(self) -> List[List[bool]]:
        return [
            [self.get(r, c) for c in range(self.cols)]
            for r in range(self.rows)
        ]

    def key(self) -> Tuple[int, int, Tuple[int, ...]]:
        return (self.rows, self.cols, tuple(self._row_bits))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SparsityPattern) and self.key() == other.key()
        )

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return (
            f"SparsityPattern({self.rows}x{self.cols}, "
            f"nnz={self.total_nnz()})"
        )


class Matching:
    """A matching in the bipartite row/column graph of a pattern."""

    __slots__ = ("row_to_col", "col_to_row")

    def __init__(self, rows: int, cols: int):
        self.row_to_col: List[int | None] = [None] * rows
        self.col_to_row: List[int | None] = [None] * cols

    def match_pair(self, r: int, c: int) -> None:
        self.row_to_col[r] = c
        self.col_to_row[c] = r

    def size(self) -> int:
        return sum(1 for x in self.row_to_col if x is not None)
