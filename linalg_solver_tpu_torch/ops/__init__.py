"""Numeric operations of the port (counterpart of ``linalg_solver_tpu.ops``).

- ``dispatch`` — ``solve_batched``, ``inverse_batched``, ``det_batched``
  and ``rank_batched`` with backend routing and autograd
- ``rbt`` — random-butterfly preconditioned pivot-free solve + rescue,
  the seeded butterfly and probe draws
- ``lu_blocked`` — the pivoted solve the rescue ends in
- ``kernels`` — hand-written CUDA kernels beside their plain versions,
  and the facade the inverse, det and rank route to
"""
