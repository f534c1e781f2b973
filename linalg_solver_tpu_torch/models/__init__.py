"""Pipelines of the port (counterpart of ``linalg_solver_tpu.models``).

- ``solver`` — ``BatchedSolver``, the batched dense solver's production
  entry point (batch-sharded over a device mesh when given one), and the
  preconditioner training step over a ``("dp", "tp")`` mesh
- ``spectral`` — ``spectral_pipeline``: eigenvalues, multiplicities and
  diagonalization of a batch (the symmetric and QR routes; the Schur
  routes are not ported)
- ``jordan`` — ``jordan_analysis``: the Weyr characteristic and Jordan
  block structure at given eigenvalues
"""

from .solver import (
    BatchedSolver,
    TrainState,
    init_train_state,
    make_training_step,
)
from .jordan import JordanReport, jordan_analysis
from .spectral import SpectralReport, spectral_pipeline

__all__ = [
    "BatchedSolver",
    "TrainState",
    "init_train_state",
    "make_training_step",
    "SpectralReport",
    "spectral_pipeline",
    "JordanReport",
    "jordan_analysis",
]
