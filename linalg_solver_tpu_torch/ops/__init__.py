"""Numeric operations of the port (counterpart of ``linalg_solver_tpu.ops``).

- ``dispatch`` — ``solve_batched``, ``inverse_batched``, ``det_batched``
  and ``rank_batched`` with backend routing and autograd
- ``rbt`` — random-butterfly preconditioned pivot-free solve and
  inverse + rescue: the fused engine and the phase engine, the seeded
  butterfly and probe draws
- ``lu_blocked`` — the pivoted solve and inverse the rescues end in, and
  the triangular inverses of the phase engine
- ``kernels`` — hand-written CUDA kernels beside their plain versions,
  and the facade the inverse, det and rank route to
"""
