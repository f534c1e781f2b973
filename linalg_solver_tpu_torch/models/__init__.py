"""Pipelines of the port (counterpart of ``linalg_solver_tpu.models``).

- ``solver`` — ``BatchedSolver``, the batched dense solver's production
  entry point, on one GPU
- ``spectral`` — ``spectral_pipeline``: eigenvalues, multiplicities and
  diagonalization of a batch (the symmetric and QR routes; the Schur
  routes are not ported)
- ``jordan`` — ``jordan_analysis``: the Weyr characteristic and Jordan
  block structure at given eigenvalues
"""

from .solver import BatchedSolver
from .jordan import JordanReport, jordan_analysis
from .spectral import SpectralReport, spectral_pipeline

__all__ = [
    "BatchedSolver",
    "SpectralReport",
    "spectral_pipeline",
    "JordanReport",
    "jordan_analysis",
]
