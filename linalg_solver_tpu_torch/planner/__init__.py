"""Combinatorial planning layer: optimal determinant strategies, DM
decomposition, and pattern canonicalization (counterpart of
``linalg_solver_tpu.planner``).

Two interchangeable engines provide the same API:

- the pure-Python engine in this package (pattern / graphs / dm /
  canonical / search modules);
- the C++ native engine (``csrc/planner.cpp``, built with ``g++`` at first
  use and loaded via ``native.py``) — same algorithms and cost model, used
  by default because the search is the hot combinatorial loop.  A failed
  build raises: the two engines agree on cost but may pick different
  processes among equal-cost ones, and the process decides the text.

Set ``LINALG_TPU_NATIVE=0`` to choose the Python engine.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

from .canonical import CanonicalForm, are_permutation_equivalent, canonicalize
from .dm import DMResult, dulmage_mendelsohn
from .graphs import hopcroft_karp, tarjan_scc
from .pattern import Matching, SparsityPattern
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
from .search import find_optimal_process, plan_anytime


@dataclass
class OptimalProcessResult:
    cost: Cost
    process: Process

    def __repr__(self) -> str:
        return f"OptimalProcessResult(cost={self.cost!r}, process=...)"


def _native_enabled() -> bool:
    return os.environ.get("LINALG_TPU_NATIVE", "1") != "0"


def _load_native():
    """The native engine's module, its library built and loaded, unless
    ``LINALG_TPU_NATIVE=0`` chooses the Python engine (then None)."""
    if not _native_enabled():
        return None
    from . import native

    native.load()
    return native


def find_optimal_determinant_process(
    matrix: List[List[bool]],
) -> OptimalProcessResult:
    """Plan the cheapest determinant strategy for a boolean sparsity pattern."""
    nat = _load_native()
    if nat is not None:
        cost, process = nat.find_optimal_process(matrix)
        return OptimalProcessResult(cost, process)
    cost, process = find_optimal_process(SparsityPattern.from_bools(matrix))
    return OptimalProcessResult(cost, process)


def dm_decomposition(matrix: List[List[bool]]) -> DMResult:
    """Dulmage–Mendelsohn block-triangularization of a sparsity pattern."""
    nat = _load_native()
    if nat is not None:
        return nat.dm_decomposition(matrix)
    return dulmage_mendelsohn(SparsityPattern.from_bools(matrix))


def canonicalize_matrix(matrix: List[List[bool]]) -> CanonicalForm:
    """Canonical form C = PXQ invariant under row/column permutation."""
    nat = _load_native()
    if nat is not None:
        return nat.canonicalize_matrix(matrix)
    return canonicalize(SparsityPattern.from_bools(matrix))


def check_permutation_equivalent(
    a: List[List[bool]], b: List[List[bool]]
) -> bool:
    """True iff A = P·B·Q for some permutation matrices P, Q."""
    nat = _load_native()
    if nat is not None:
        return nat.check_permutation_equivalent(a, b)
    return are_permutation_equivalent(
        SparsityPattern.from_bools(a), SparsityPattern.from_bools(b)
    )


__all__ = [
    "OptimalProcessResult",
    "find_optimal_determinant_process",
    "dm_decomposition",
    "canonicalize_matrix",
    "check_permutation_equivalent",
    "find_optimal_process",
    "plan_anytime",
    "SparsityPattern",
    "Matching",
    "hopcroft_karp",
    "tarjan_scc",
    "DMResult",
    "dulmage_mendelsohn",
    "CanonicalForm",
    "canonicalize",
    "are_permutation_equivalent",
    "Cost",
    "Process",
    "Direct",
    "RowExpansion",
    "ColExpansion",
    "BlockTriangular",
    "AddRow",
    "Nonzeros",
    "remap_process",
    "canonicalize_process",
]
