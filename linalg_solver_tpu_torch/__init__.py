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
  non-symmetric batches.
"""
