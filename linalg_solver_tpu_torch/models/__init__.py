"""Pipelines of the port (counterpart of ``linalg_solver_tpu.models``).

- ``solver`` — ``BatchedSolver``, the batched dense solver's production
  entry point, on one GPU
"""
