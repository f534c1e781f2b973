"""Spectral pipeline: batched eigen-analysis of matrix families
(counterpart of ``linalg_solver_tpu.models.spectral``; BASELINE configs
4 and 5).

One report per batch: eigenvalues, algebraic multiplicities (tolerance
clustering), geometric multiplicities (the nullity of A − λI) and the
diagonalization.  Eigenvalues come from the symmetric direct solver
(``method="eigh"``, and ``"auto"`` on a symmetric batch) or the legacy
unreduced QR iteration (``method="qr"``); ``_spectral_core`` takes
eigenvalues computed elsewhere.

Not ported, and refused rather than sent to another eigensolver: the
Francis real-Schur solver of ``ops/schur.py`` behind the reference's
default ``method="schur"``, its eigenvector variant ``method="eig"``,
and ``"auto"`` on a batch that is not symmetric (ROADMAP.md queue 1
item 10); the device mesh of ``spectral_pipeline_sharded`` (queue 1
item 13).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.eigen import eigvals_qr_batched, spectral_decompose_batched
from ..ops.symmetric import eigh_batched, is_symmetric_batched

METHODS = ("schur", "eig", "qr", "eigh", "auto")


class SpectralReport(NamedTuple):
    eig_real: torch.Tensor        # [B, n]
    eig_imag: torch.Tensor        # [B, n]
    alg_mult: torch.Tensor        # [B, n] algebraic multiplicity per slot
    geom_mult: torch.Tensor       # [B, n] geometric multiplicity per slot
    diagonalizable: torch.Tensor  # [B] bool
    P: torch.Tensor               # [B, n, n]
    P_inv: torch.Tensor           # [B, n, n]
    D: torch.Tensor               # [B, n, n]


def _schur_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"spectral_pipeline({what}) needs the Francis real-Schur "
        f"eigensolver of ops/schur.py, which is not ported yet (ROADMAP.md "
        f"queue 1 item 10); method='eigh' serves symmetric batches and "
        f"method='qr' small ones")


def _spectral_core(a: torch.Tensor, ev_real: torch.Tensor,
                   ev_imag: torch.Tensor, tol: float,
                   max_distinct: Optional[int] = None) -> SpectralReport:
    """Multiplicities and diagonalization given precomputed eigenvalues:
    one ``ops.eigen.spectral_decompose_batched`` (the distinct
    eigenvalues' shifted matrices through one batched Gauss–Jordan pass
    a chunk; ``space_tol`` at its default ``tol/10``, since the shifts
    are cluster means)."""
    dec = spectral_decompose_batched(a, ev_real, ev_imag, tol=tol,
                                     max_distinct=max_distinct)
    return SpectralReport(dec.eigenvalues, dec.eig_imag, dec.alg_mult,
                          dec.geom_mult, dec.success, dec.P, dec.P_inv, dec.D)


def spectral_pipeline(a: torch.Tensor, iters: int = 100, tol: float = 1e-3,
                      method: str = "schur",
                      max_distinct: Optional[int] = None) -> SpectralReport:
    """Full spectral report for a batch ``a [B, n, n]``.

    ``method="eigh"``: symmetric input, the spectral theorem's path: one
    direct symmetric eigensolve, P orthogonal (P⁻¹ = Pᵀ, no inverse
    solve), always diagonalizable, alg = geom by clustering.
    ``method="qr"``: the unreduced QR iteration (``iters`` steps), then
    the spectral core.  ``method="auto"``: ``"eigh"`` if every matrix is
    numerically symmetric (one host read), else the Schur path.

    ``"schur"`` (the reference's default), ``"eig"`` and ``"auto"`` on a
    non-symmetric batch raise ``NotImplementedError``: ``ops/schur.py``
    is not ported.  ``max_distinct`` bounds the distinct eigenvalues
    whose eigenspaces the Schur path computes."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if method == "auto":
        if not bool(is_symmetric_batched(a).all()):
            raise _schur_not_ported("method='auto' on a non-symmetric batch")
        method = "eigh"
    if method in ("schur", "eig"):
        raise _schur_not_ported(f"method={method!r}")
    if method == "eigh":
        return _report_from_eigh(a, tol)
    return _spectral_pipeline_qr(a, iters=iters, tol=tol)


def _report_from_eigh(a: torch.Tensor, tol: float) -> SpectralReport:
    """SpectralReport from the symmetric direct eigensolver: slots by
    descending eigenvalue (``eigh`` returns them ascending), P the
    orthogonal eigenvector matrix, P⁻¹ = Pᵀ exactly, D = diag(w)."""
    res = eigh_batched(a)
    w = res.w.flip(-1)
    P = res.V.flip(-1)
    alg = ((w[:, :, None] - w[:, None, :]).abs() <= tol).sum(dim=2).to(
        torch.int32)
    return SpectralReport(
        w, torch.zeros_like(w), alg, alg,
        torch.ones(a.shape[0], dtype=torch.bool, device=a.device),
        P, P.transpose(1, 2), torch.diag_embed(w))


def _spectral_pipeline_qr(a: torch.Tensor, iters: int = 100,
                          tol: float = 1e-3) -> SpectralReport:
    ev = eigvals_qr_batched(a, iters=iters)
    return _spectral_core(a, ev.real, ev.imag, tol)


def spectral_pipeline_sharded(a: torch.Tensor, mesh, tol: float = 1e-3,
                              max_distinct: Optional[int] = None
                              ) -> SpectralReport:
    """The reference's ``spectral_pipeline`` over a device mesh: not
    ported (one GPU; ROADMAP.md queue 1 item 13)."""
    raise NotImplementedError(
        "spectral_pipeline_sharded (the batch over a device mesh) is not "
        "ported yet (ROADMAP.md queue 1 item 13); it also needs "
        "ops/schur.py (queue 1 item 10)")
