"""linalg_solver_tpu_torch — the PyTorch/CUDA port of ``linalg_solver_tpu``.

Module paths and function names follow the JAX package, so each
function's counterpart is found under the same name there.  The port
imports ``torch`` and numpy only; its hand-written CUDA kernels live in
``csrc/`` and are compiled with ``nvcc`` at first use
(``ops/kernels/_build.py``).

Ported so far:

- the batched dense solve ``ops.dispatch.solve_batched``
  (random-butterfly preconditioning + pivot-free LU + refinement in one
  kernel launch, with a lane-compacted rescue);
- the batched small-N inverse ``ops.dispatch.inverse_batched`` (the
  fused RBT inverse with its gate and rescue in one kernel launch, and
  the pivoted Gauss–Jordan kernel beside it), with ``det_batched`` and
  ``rank_batched`` on the pivoted kernel;
- the RBT phase engine (``ops.rbt``'s ``engine="kernel"``: the one-pass
  two-sided butterfly kernel and the no-pivot panel LU kernel), behind
  the solve with a wide matrix RHS or N past the fused kernel and the
  inverse past the small-N kernels (N a multiple of 8 below 1024);
- the pivoted blocked LU on the masked partial-pivot panel kernel
  (``ops.lu_blocked``): the ``"mixed"`` and ``"blocked_pallas"`` solve
  backends, ``"blocked_pallas"`` inverse and determinant (the
  determinant's route past the pivoted kernel), and
  ``ops.dispatch.lu_factor_batched``; and the large-N RBT block
  elimination (``ops.lu_large``, ``ops.lu_recursive``) behind the solve
  from N = 1024;
- the pivoted, rank-revealing half: the reference's loops (``ops.rref``,
  ``ops.lu``, ``ops.solve``: the ``"loop"`` backend and oracle), the
  blocked RREF (``ops.rref_blocked``), ``ops.dispatch
  .affine_solve_batched`` / ``nullspace_batched`` and the rank on the
  pivoted kernel to its big reach, and ``models.solver.BatchedSolver``
  on one GPU;
- the device eigen stack: ``ops.eigen``, ``ops.orth``, ``ops.symmetric``,
  ``ops.generate``, ``models.jordan.jordan_analysis`` and
  ``models.spectral.spectral_pipeline``'s symmetric and QR routes;
- the real Schur solver ``ops.schur`` (balancing, Hessenberg, multishift
  Francis QR with aggressive early deflation, the Schur vectors and the
  real eigenvectors), behind ``eigvals_schur``, ``eig_real_batched`` and
  ``spectral_pipeline``'s ``"schur"``, ``"eig"`` and ``"auto"`` routes on
  non-symmetric batches;
- the exact host path (``exact``, ``planner``, ``trace``) with its LaTeX
  derivations byte for byte the JAX package's, without sympy, the exact
  eigen stack on rational and quadratic roots, and the CLI
  (``python -m linalg_solver_tpu_torch``);
- the tridiagonal family: ``ops.tridiag`` (cyclic reduction),
  ``ops.sturm`` (Sturm bisection on a kernel, twisted-factorization
  eigenvectors) and ``ops.randomized`` (randomized SVD, ID, CUR).
"""

from .exact import (
    AffineSubspace,
    DiagonalizationResult,
    Matrix,
    NoSolution,
    Permutation,
    Polynomial,
    RandomMatrixBuilder,
    RowColPermutation,
    gen_diagonalizable_matrix,
    gen_jordan_matrix,
    gen_matrix_with_jordan_blocks,
    gen_matrix_with_rank,
    gen_regular_matrix,
    gen_unimodular_matrix,
    raw_gen_rand_matrix,
)
from .utils import (
    Logger,
    capture_logs,
    cformat,
    global_logger,
    ignore_log,
    log,
    make_latex_augmented_matrix,
    make_latex_matrix,
    make_latex_vector,
    make_latex_vertical_augmented_matrix,
    nest_appending_logger,
    nest_logger,
)

__version__ = "0.1.0"

__all__ = [
    "Matrix",
    "Polynomial",
    "Permutation",
    "RowColPermutation",
    "AffineSubspace",
    "NoSolution",
    "DiagonalizationResult",
    "RandomMatrixBuilder",
    "raw_gen_rand_matrix",
    "gen_regular_matrix",
    "gen_matrix_with_rank",
    "gen_jordan_matrix",
    "gen_matrix_with_jordan_blocks",
    "gen_diagonalizable_matrix",
    "gen_unimodular_matrix",
    "cformat",
    "make_latex_matrix",
    "make_latex_vector",
    "make_latex_augmented_matrix",
    "make_latex_vertical_augmented_matrix",
    "log",
    "Logger",
    "global_logger",
    "nest_logger",
    "nest_appending_logger",
    "ignore_log",
    "capture_logs",
]
