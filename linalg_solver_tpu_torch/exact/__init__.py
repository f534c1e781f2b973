"""Exact-arithmetic host path: element-generic matrices with full LaTeX
derivation tracing (counterpart of ``linalg_solver_tpu.exact``).  The
CUDA numeric path lives in ``..ops`` / ``..models``."""

from .matrix import (
    AffineSubspace,
    DiagonalizationResult,
    Matrix,
    NoSolution,
    from_reference_items,
)
from .permutation import Permutation, RowColPermutation
from .polynomial import Polynomial
from .radicals import Surd
from .random_matrix import (
    RandomMatrixBuilder,
    gen_diagonalizable_matrix,
    gen_jordan_matrix,
    gen_matrix_with_jordan_blocks,
    gen_matrix_with_rank,
    gen_regular_matrix,
    gen_unimodular_matrix,
    raw_gen_rand_matrix,
)

__all__ = [
    "Matrix",
    "AffineSubspace",
    "NoSolution",
    "DiagonalizationResult",
    "Permutation",
    "RowColPermutation",
    "Polynomial",
    "Surd",
    "from_reference_items",
    "RandomMatrixBuilder",
    "raw_gen_rand_matrix",
    "gen_regular_matrix",
    "gen_matrix_with_rank",
    "gen_jordan_matrix",
    "gen_matrix_with_jordan_blocks",
    "gen_diagonalizable_matrix",
    "gen_unimodular_matrix",
]
