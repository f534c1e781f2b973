"""Numeric operations of the port (counterpart of ``linalg_solver_tpu.ops``).

- ``dispatch`` — ``solve_batched`` with backend routing and autograd
- ``rbt`` — random-butterfly preconditioned pivot-free solve + rescue
- ``lu_blocked`` — the pivoted solve the rescue ends in
- ``kernels`` — hand-written CUDA kernels beside their plain versions
"""
