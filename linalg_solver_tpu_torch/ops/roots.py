"""Batched polynomial root finding: companion matrix + real Schur
(counterpart of ``linalg_solver_tpu.ops.roots``).

Builds the companion matrices of a batch of polynomials and runs the
real-Schur eigensolver (``ops.schur.eigvals_schur``) on them, the
algorithm ``numpy.roots`` uses, batched.

Coefficients are dense, highest degree first (numpy convention):
``coeffs [B, d+1]`` represents ``c₀ xᵈ + … + c_d``.  Leading zeros are
not supported (they change the degree a lane; trim them on the host):
lanes with a zero leading coefficient are flagged ``ok=False``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .schur import eigvals_schur


class RootsResult(NamedTuple):
    real: torch.Tensor       # [B, d]
    imag: torch.Tensor       # [B, d]
    converged: torch.Tensor  # [B] eigensolver converged
    ok: torch.Tensor         # [B] leading coefficient nonzero


def roots_batched(coeffs: torch.Tensor, **schur_kwargs) -> RootsResult:
    """All d roots of each degree-d polynomial in the batch."""
    B, dp1 = coeffs.shape
    d = dp1 - 1
    if d < 1:
        raise ValueError("need degree >= 1 (at least 2 coefficients)")
    c = coeffs.to(torch.promote_types(coeffs.dtype, torch.float32))
    lead = c[:, 0]
    ok = lead.abs() > 0
    monic = c[:, 1:] / torch.where(ok, lead, 1.0)[:, None]     # [B, d]

    # companion matrix: subdiagonal of ones, first row −monic
    ones = torch.ones(d - 1, dtype=c.dtype, device=c.device)
    comp = torch.diag(ones, -1).expand(B, d, d).clone()
    comp[:, 0, :] = -monic
    ev = eigvals_schur(comp, **schur_kwargs)
    return RootsResult(ev.real, ev.imag, ev.converged, ok)
