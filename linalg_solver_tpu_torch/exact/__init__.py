"""Exact-arithmetic host path: element-generic matrices with full LaTeX
derivation tracing (counterpart of ``linalg_solver_tpu.exact``, without
its random-matrix builders).  The CUDA numeric path lives in ``..ops`` /
``..models``."""

from .matrix import (
    AffineSubspace,
    DiagonalizationResult,
    Matrix,
    NoSolution,
    from_reference_items,
)
from .permutation import Permutation, RowColPermutation
from .polynomial import Polynomial

__all__ = [
    "Matrix",
    "AffineSubspace",
    "NoSolution",
    "DiagonalizationResult",
    "Permutation",
    "RowColPermutation",
    "Polynomial",
    "from_reference_items",
]
