"""Matrix nearness problems: nearest PSD, nearest correlation, nearest
orthogonal matrix (counterpart of ``linalg_solver_tpu.ops.nearness``).

- ``nearest_psd_batched``: Higham (1988): the Frobenius-nearest PSD matrix
  to A is ``sym(A)`` with its eigenvalues clipped at 0 (or at
  ``shift·max|λ|``): one ``eigh`` a lane.
- ``nearest_correlation_batched``: Higham (2002): alternating projections
  with Dykstra's correction between the PSD cone and the unit-diagonal
  set, converged lanes frozen; one ``eigh`` an iteration.  The
  reference's ``while_loop`` stops here on a host read a step.
- ``nearest_orthogonal_batched``: the polar factor (QDWH,
  ``ops.svd.polar_batched``).

The reference calls the library's float32 ``eigh``; the port takes
``ops.symmetric.eigh_batched``, which runs it in float64 and rounds.  On
64 corrupted 128×128 correlation matrices on an H100 the library's float32
``eigh`` left the nearest correlation unconverged on every lane after 100
iterations (11.6 s a call) and the PSD repair 1.63e-4 from the float64
one, past the reference test's 1e-4; the float64 route converged in 29
iterations (3.1 s) and left 6.7e-7 (NVIDIA H100 80GB HBM3, 700 W;
``tests/test_torch_matfun_probe.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .schur import _f32
from .svd import polar_batched
from .symmetric import eigh_batched


class NearestPSDResult(NamedTuple):
    x: torch.Tensor         # [B, n, n] nearest PSD (symmetric, λ ≥ shift)
    distance: torch.Tensor  # [B] ‖A − X‖_F (the asymmetric part included)


def _clip_spectrum(y: torch.Tensor, shift: float = 0.0) -> torch.Tensor:
    """The symmetric part of ``y`` with its eigenvalues clipped at
    ``shift·max|λ|``, symmetrized."""
    res = eigh_batched(0.5 * (y + y.transpose(1, 2)))
    floor = shift * torch.clamp(res.w.abs().amax(dim=1, keepdim=True),
                                min=torch.finfo(y.dtype).tiny)
    x = (res.V * torch.maximum(res.w, floor)[:, None, :]) @ res.V.transpose(
        1, 2)
    return 0.5 * (x + x.transpose(1, 2))


@f32_matmuls()
def nearest_psd_batched(a: torch.Tensor, shift: float = 0.0
                        ) -> NearestPSDResult:
    """Frobenius-nearest positive semidefinite matrix (Higham 1988);
    ``shift > 0`` clips eigenvalues at ``shift·max|λ|`` instead of 0, a
    positive definite repair for a downstream Cholesky."""
    a = _f32(a)
    x = _clip_spectrum(a, shift)
    return NearestPSDResult(x, torch.sqrt(((a - x) ** 2).sum(dim=(1, 2))))


class NearestCorrResult(NamedTuple):
    x: torch.Tensor          # [B, n, n] unit-diagonal PSD
    converged: torch.Tensor  # [B] projection gap ≤ tol before max_iters
    iters: torch.Tensor      # [] int32
    distance: torch.Tensor   # [B] ‖A − X‖_F


@f32_matmuls()
def nearest_correlation_batched(a: torch.Tensor, tol: float = 1e-6,
                                max_iters: int = 100) -> NearestCorrResult:
    """Frobenius-nearest correlation matrix (symmetric PSD, unit diagonal):
    Higham's alternating projections with Dykstra's correction on the cone
    projection.  Converged lanes freeze."""
    a = _f32(a)
    B, n, _ = a.shape
    y = 0.5 * (a + a.transpose(1, 2))
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    scale = torch.clamp(torch.sqrt((y * y).sum(dim=(1, 2))), min=1e-30)
    ds = torch.zeros_like(y)
    done = torch.zeros(B, dtype=torch.bool, device=a.device)
    k = 0
    while k < max_iters and not bool(done.all()):
        r = y - ds
        xp = _clip_spectrum(r)
        ds_new = xp - r
        # project onto the unit diagonal
        y_new = xp - (xp.diagonal(0, 1, 2) - 1.0)[:, :, None] * eye
        gap = torch.sqrt(((y_new - y) ** 2).sum(dim=(1, 2))) / scale
        sel = done[:, None, None]
        y = torch.where(sel, y, y_new)
        ds = torch.where(sel, ds, ds_new)
        done = done | (gap <= tol)
        k += 1
    # final PSD polish and an exact unit diagonal (the last iterate is unit
    # diagonal but may be eps-indefinite)
    x = _clip_spectrum(y)
    dinv = 1.0 / torch.sqrt(torch.clamp(x.diagonal(0, 1, 2), min=1e-12))
    x = x * dinv[:, :, None] * dinv[:, None, :]
    return NearestCorrResult(x, done, torch.tensor(k, dtype=torch.int32,
                                                   device=a.device),
                             torch.sqrt(((a - x) ** 2).sum(dim=(1, 2))))


def nearest_orthogonal_batched(a: torch.Tensor):
    """Nearest orthogonal matrix (any unitarily invariant norm): the polar
    factor of A.  Returns ``(q, distance, ok)``."""
    res = polar_batched(a)
    d = torch.sqrt(((a.to(res.up.dtype) - res.up) ** 2).sum(dim=(1, 2)))
    return res.up, d, res.ok
