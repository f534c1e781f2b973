"""Permutation algebra for determinant computations (counterpart of
``linalg_solver_tpu.exact.permutation``).

``Permutation`` is a permutation of ``0..n-1`` stored in one-line notation
(``perm[i] = j`` means ``i -> j``).  ``RowColPermutation`` bundles a row and a
column permutation, representing ``P A Q``.  The native planner
(``csrc/planner.cpp``) carries its own internal permutation representation
for the hot combinatorial search.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple


class Permutation:
    __slots__ = ("_perm",)

    def __init__(self, perm: Sequence[int], _validate: bool = True):
        perm = list(perm)
        if _validate:
            n = len(perm)
            seen = [False] * n
            for p in perm:
                if not (0 <= p < n) or seen[p]:
                    raise ValueError(
                        "Input list is not a valid permutation of 0..n-1"
                    )
                seen[p] = True
        self._perm = perm

    # -- construction -----------------------------------------------------
    @staticmethod
    def id(n: int) -> "Permutation":
        return Permutation(list(range(n)), _validate=False)

    identity = id

    # -- basics -----------------------------------------------------------
    def __call__(self, i: int) -> int:
        return self._perm[i]

    def __getitem__(self, i: int) -> int:
        return self._perm[i]

    def __len__(self) -> int:
        return len(self._perm)

    def __iter__(self) -> Iterator[int]:
        return iter(self._perm)

    def __eq__(self, other) -> bool:
        return isinstance(other, Permutation) and self._perm == other._perm

    def __hash__(self) -> int:
        return hash(tuple(self._perm))

    @property
    def perm(self) -> List[int]:
        return list(self._perm)

    def to_vec(self) -> List[int]:
        return list(self._perm)

    def as_slice(self) -> List[int]:
        return self._perm

    def is_id(self) -> bool:
        return all(i == p for i, p in enumerate(self._perm))

    # -- algebra ----------------------------------------------------------
    def compose(self, other: "Permutation") -> "Permutation":
        """(self * other)(i) = self(other(i))"""
        if len(self) != len(other):
            raise ValueError("Permutations must have same length")
        return Permutation(
            [self._perm[other._perm[i]] for i in range(len(self))],
            _validate=False,
        )

    def __mul__(self, other: "Permutation") -> "Permutation":
        return self.compose(other)

    def inverse(self) -> "Permutation":
        inv = [0] * len(self._perm)
        for i, p in enumerate(self._perm):
            inv[p] = i
        return Permutation(inv, _validate=False)

    # -- cycle structure --------------------------------------------------
    def _cycles_and_count(self) -> Tuple[List[List[int]], int]:
        n = len(self._perm)
        visited = [False] * n
        cycles: List[List[int]] = []
        for i in range(n):
            if visited[i]:
                continue
            cycle = []
            j = i
            while not visited[j]:
                visited[j] = True
                cycle.append(j)
                j = self._perm[j]
            cycles.append(cycle)
        return cycles, len(cycles)

    def cycle_decomposition(self) -> List[List[int]]:
        """Cycles of length > 1 only."""
        cycles, _ = self._cycles_and_count()
        return [c for c in cycles if len(c) > 1]

    def sign(self) -> int:
        """+1 for even permutations, -1 for odd."""
        n = len(self._perm)
        if n == 0:
            return 1
        _, num_cycles = self._cycles_and_count()
        return 1 if (n - num_cycles) % 2 == 0 else -1

    def cost(self) -> int:
        """Minimum number of transpositions = sum over cycles of (len - 1)."""
        return sum(len(c) - 1 for c in self.cycle_decomposition())

    def try_get_one_transpose(self) -> Optional[Tuple[int, int]]:
        """If the permutation is a single transposition, return its pair."""
        cd = self.cycle_decomposition()
        if len(cd) == 1 and len(cd[0]) == 2:
            return (cd[0][0], cd[0][1])
        return None

    # -- rendering --------------------------------------------------------
    def cformat(self, arg_of: Optional[str] = None) -> str:
        """Cycle notation with 1-based indices, or ``\\text{id}``."""
        cycles = self.cycle_decomposition()
        if not cycles:
            return r"\text{id}"
        return "".join(
            "(" + " ".join(str(x + 1) for x in cycle) + ")" for cycle in cycles
        )

    def __repr__(self) -> str:
        return f"Permutation({self._perm!r})"

    def __str__(self) -> str:
        return self.cformat()


class RowColPermutation:
    """A pair of permutations (P, Q) acting on a matrix as ``P A Q``."""

    __slots__ = ("_row", "_col")

    def __init__(self, row_perm: Sequence[int], col_perm: Sequence[int]):
        self._row = row_perm if isinstance(row_perm, Permutation) else Permutation(row_perm)
        self._col = col_perm if isinstance(col_perm, Permutation) else Permutation(col_perm)

    @staticmethod
    def id(n: int) -> "RowColPermutation":
        return RowColPermutation(Permutation.id(n), Permutation.id(n))

    identity = id

    @staticmethod
    def matrix_transpose(n: int) -> "RowColPermutation":
        """Simultaneous reversal of row and column order (NOT a mathematical
        transpose — a cost-reducing relabeling)."""
        rev = list(range(n - 1, -1, -1))
        return RowColPermutation(
            Permutation(rev, _validate=False), Permutation(list(rev), _validate=False)
        )

    @property
    def row_perm(self) -> Permutation:
        return self._row

    @property
    def col_perm(self) -> Permutation:
        return self._col

    def __len__(self) -> int:
        return len(self._row)

    def __call__(self, i: int, j: int) -> Tuple[int, int]:
        return (self._row[i], self._col[j])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RowColPermutation)
            and self._row == other._row
            and self._col == other._col
        )

    def is_id(self) -> bool:
        return self._row.is_id() and self._col.is_id()

    def compose(self, other: "RowColPermutation") -> "RowColPermutation":
        """(P A Q) then (P' _ Q')  =>  (P∘P') A (Q'∘Q)."""
        return RowColPermutation(
            self._row.compose(other._row), other._col.compose(self._col)
        )

    def __mul__(self, other: "RowColPermutation") -> "RowColPermutation":
        return self.compose(other)

    def with_transpose(self) -> "RowColPermutation":
        return self.compose(RowColPermutation.matrix_transpose(len(self)))

    def cost(self) -> int:
        return self._row.cost() + self._col.cost()

    def try_transpose(self) -> Tuple["RowColPermutation", bool]:
        """Apply the simultaneous reversal iff it lowers cost()+1."""
        flipped = self.with_transpose()
        if flipped.cost() + 1 < self.cost():
            return (flipped, True)
        return (self, False)

    def to_rows_cols_permutations(self) -> Tuple[Permutation, Permutation]:
        return (self._row, self._col)

    def inverse(self) -> "RowColPermutation":
        return RowColPermutation(self._row.inverse(), self._col.inverse())

    def __repr__(self) -> str:
        return (
            f"RowColPermutation(row={self._row.perm!r}, col={self._col.perm!r})"
        )

    def __str__(self) -> str:
        return (
            f"RowColPermutation(row={self._row.cformat()}, "
            f"col={self._col.cformat()})"
        )
