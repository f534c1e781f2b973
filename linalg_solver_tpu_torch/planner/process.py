"""Process algebra for determinant computation strategies.

A ``Process`` is a tree describing *how* to compute a determinant given only
the sparsity pattern of the matrix: direct Leibniz evaluation, Laplace
expansion along a row/column, block-triangular factorization, or a
determinant-preserving AddRow elimination followed by a cheaper subprocess.

The ``Cost`` model counts exact scalar multiplications and additions
(excluding trivial ×(-1) and +0), matching the reference planner's contract
(linalg-solver's linalg-helper/src/determinant.rs:25-115,553-563).

These classes are shared by the pure-Python planner (``pyplanner``), the C++
native planner binding (``native``), and the exact-path executor
(``linalg_solver_tpu.exact.determinant_exec``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..exact.permutation import Permutation


# ---------------------------------------------------------------------------
# Sparsity bookkeeping
# ---------------------------------------------------------------------------

class Nonzeros:
    """Positions expected to be nonzero, as a set of ``(row, col)`` pairs."""

    __slots__ = ("rows", "cols", "_entries")

    def __init__(self, rows: int, cols: int,
                 entries: Optional[List[Tuple[int, int]]] = None):
        self.rows = rows
        self.cols = cols
        self._entries = set()
        if entries:
            for r, c in entries:
                if not (0 <= r < rows and 0 <= c < cols):
                    raise ValueError("Entry out of bounds for Nonzeros")
                self._entries.add((r, c))

    @staticmethod
    def from_pattern(pattern: List[List[bool]]) -> "Nonzeros":
        rows = len(pattern)
        cols = len(pattern[0]) if rows else 0
        nz = Nonzeros(rows, cols)
        for r in range(rows):
            for c in range(cols):
                if pattern[r][c]:
                    nz._entries.add((r, c))
        return nz

    def contains(self, r: int, c: int) -> bool:
        return (r, c) in self._entries

    def entries(self) -> List[Tuple[int, int]]:
        return sorted(self._entries)

    def count(self) -> int:
        return len(self._entries)

    def permute(self, row_perm: Permutation, col_perm: Permutation) -> "Nonzeros":
        """Map old index -> new index through the given permutations."""
        out = Nonzeros(len(row_perm), len(col_perm))
        out._entries = {(row_perm[r], col_perm[c]) for r, c in self._entries}
        return out

    def permute_inv(self, row_perm: Permutation, col_perm: Permutation) -> "Nonzeros":
        return self.permute(row_perm.inverse(), col_perm.inverse())

    def __repr__(self) -> str:
        return (
            f"Nonzeros(rows={self.rows}, cols={self.cols}, "
            f"count={self.count()})"
        )


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Cost:
    multiplications: int = 0
    additions: int = 0

    @property
    def total(self) -> int:
        return self.multiplications + self.additions

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(
            self.multiplications + other.multiplications,
            self.additions + other.additions,
        )

    def add_mults(self, n: int) -> "Cost":
        return Cost(self.multiplications + n, self.additions)

    def add_adds(self, n: int) -> "Cost":
        return Cost(self.multiplications, self.additions + n)

    @staticmethod
    def zero() -> "Cost":
        return Cost(0, 0)

    @staticmethod
    def direct(size: int) -> "Cost":
        """Cost of direct Leibniz evaluation of a dense size×size block."""
        if size <= 1:
            return Cost(0, 0)
        if size == 2:
            return Cost(2, 1)  # a*d - b*c
        n_fact = math.factorial(size)
        return Cost(n_fact * (size - 1), n_fact - 1)

    def __repr__(self) -> str:
        return (
            f"Cost(multiplications={self.multiplications}, "
            f"additions={self.additions}, total={self.total})"
        )


# ---------------------------------------------------------------------------
# Process variants
# ---------------------------------------------------------------------------

@dataclass
class Direct:
    """Direct evaluation (closed form for n<=2, Leibniz otherwise)."""
    size: int

    kind = "Direct"


@dataclass
class RowExpansion:
    """Laplace expansion along ``row``; ``minors`` holds
    ``(col_index, subprocess)`` for each nonzero entry of that row."""
    row: int
    minors: List[Tuple[int, "Process"]]

    kind = "RowExpansion"


@dataclass
class ColExpansion:
    col: int
    minors: List[Tuple[int, "Process"]]

    kind = "ColExpansion"


@dataclass
class BlockTriangular:
    """Row/col permutations bring the matrix to upper block-triangular form;
    det = product of diagonal block determinants (times permutation signs)."""
    blocks: List["Process"]
    row_perm: Permutation
    col_perm: Permutation

    kind = "BlockTriangular"


@dataclass
class AddRow:
    """Add a multiple of row ``src`` to row ``dst`` zeroing ``(dst, pivot_col)``;
    determinant is unchanged and ``result`` handles the sparser matrix."""
    src: int
    dst: int
    pivot_col: int
    result: "Process"

    kind = "AddRow"


Variant = Direct | RowExpansion | ColExpansion | BlockTriangular | AddRow


@dataclass
class Process:
    raw: Variant
    expected_nonzeros: Nonzeros = field(repr=False)

    @property
    def size(self) -> int:
        raw = self.raw
        if isinstance(raw, Direct):
            return raw.size
        if isinstance(raw, (RowExpansion, ColExpansion)):
            if raw.minors:
                return 1 + raw.minors[0][1].size
            return 1
        if isinstance(raw, BlockTriangular):
            return sum(b.size for b in raw.blocks)
        if isinstance(raw, AddRow):
            return raw.result.size
        raise TypeError(f"Unknown process variant: {raw!r}")

    def format_tree(self, indent: int = 0) -> str:
        pad = "  " * indent
        raw = self.raw
        if isinstance(raw, Direct):
            return f"{pad}Direct(size={raw.size})"
        if isinstance(raw, RowExpansion):
            out = f"{pad}RowExpansion(row={raw.row}):"
            for col, sub in raw.minors:
                out += f"\n{pad}  col={col} =>\n" + sub.format_tree(indent + 2)
            return out
        if isinstance(raw, ColExpansion):
            out = f"{pad}ColExpansion(col={raw.col}):"
            for row, sub in raw.minors:
                out += f"\n{pad}  row={row} =>\n" + sub.format_tree(indent + 2)
            return out
        if isinstance(raw, BlockTriangular):
            out = (
                f"{pad}BlockTriangular(row_perm={raw.row_perm.perm}, "
                f"col_perm={raw.col_perm.perm}):"
            )
            for i, block in enumerate(raw.blocks):
                out += f"\n{pad}  block[{i}] =>\n" + block.format_tree(indent + 2)
            return out
        if isinstance(raw, AddRow):
            out = (
                f"{pad}AddRow(src={raw.src}, dst={raw.dst}, "
                f"pivot_col={raw.pivot_col}):"
            )
            out += "\n" + raw.result.format_tree(indent + 1)
            return out
        raise TypeError(f"Unknown process variant: {raw!r}")

    def __str__(self) -> str:
        return self.format_tree()


def _induced_minor_perm(exclude_old: int, exclude_new: int,
                        index_map: Permutation) -> Permutation:
    """The permutation a top-level index remap induces on a minor's local
    coordinates.

    A minor's local index i refers to the i-th *remaining* index in sorted
    order.  Remapping the parent reorders which original indices sit at
    which sorted positions, so the minor's coordinate system permutes:
    old local i (= sorted remaining w/o ``exclude_old``, position i) lands
    at the sorted position of ``index_map[i-th remaining]`` among the new
    remaining indices (w/o ``exclude_new``).
    """
    n = len(index_map)
    old_remaining = [k for k in range(n) if k != exclude_old]
    new_remaining = sorted(
        index_map[k] for k in old_remaining
    )
    assert exclude_new not in new_remaining
    position = {v: i for i, v in enumerate(new_remaining)}
    return Permutation(
        [position[index_map[k]] for k in old_remaining], _validate=False
    )


def remap_process(process: Process, row_map: Permutation,
                  col_map: Permutation) -> Process:
    """Apply index mappings to a process's coordinates, recursively.

    Block-triangular blocks live in coordinates defined by the (composed)
    block permutation itself, so they are shared untouched.  Expansion
    minors live in sorted-remaining-index coordinates, whose ORDER changes
    under a general remap — each minor is remapped by the induced
    permutation of its local coordinate system (this is the soundness fix
    over the reference's remap, which left minors untouched and relied on
    a runtime sparsity check to fail fast; see determinant.rs:898-954).
    An AddRow result is the same size as its parent: remapped directly.
    """
    if row_map.is_id() and col_map.is_id():
        return process

    raw = process.raw
    if isinstance(raw, Direct):
        new_raw: Variant = Direct(raw.size)
    elif isinstance(raw, RowExpansion):
        new_minors = []
        rho = _induced_minor_perm(raw.row, row_map[raw.row], row_map)
        for c, sub in raw.minors:
            sigma = _induced_minor_perm(c, col_map[c], col_map)
            new_minors.append((col_map[c], remap_process(sub, rho, sigma)))
        new_raw = RowExpansion(row_map[raw.row], new_minors)
    elif isinstance(raw, ColExpansion):
        new_minors = []
        sigma = _induced_minor_perm(raw.col, col_map[raw.col], col_map)
        for r, sub in raw.minors:
            rho = _induced_minor_perm(r, row_map[r], row_map)
            new_minors.append((row_map[r], remap_process(sub, rho, sigma)))
        new_raw = ColExpansion(col_map[raw.col], new_minors)
    elif isinstance(raw, BlockTriangular):
        new_raw = BlockTriangular(
            list(raw.blocks),
            row_map.compose(raw.row_perm),
            col_map.compose(raw.col_perm),
        )
    elif isinstance(raw, AddRow):
        new_raw = AddRow(
            row_map[raw.src],
            row_map[raw.dst],
            col_map[raw.pivot_col],
            remap_process(raw.result, row_map, col_map),
        )
    else:
        raise TypeError(f"Unknown process variant: {raw!r}")
    return Process(
        new_raw, process.expected_nonzeros.permute(row_map, col_map)
    )


def canonicalize_process(process: Process, row_perm: Permutation,
                         col_perm: Permutation) -> Process:
    """Express a process in canonical coordinates given the canonical->original
    permutations (i.e. remap through their inverses)."""
    return remap_process(process, row_perm.inverse(), col_perm.inverse())
