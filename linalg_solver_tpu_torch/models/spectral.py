"""Spectral pipeline: batched eigen-analysis of matrix families
(counterpart of ``linalg_solver_tpu.models.spectral``; BASELINE configs
4 and 5).

One report per batch: eigenvalues, algebraic multiplicities (tolerance
clustering), geometric multiplicities (the nullity of A − λI) and the
diagonalization.  Eigenvalues come from the Francis real-Schur solver
(``ops.schur``: ``method="schur"``, the default, and ``"auto"`` on a
batch that is not symmetric), from it with its eigenvectors
(``method="eig"``), from the symmetric direct solver (``method="eigh"``,
and ``"auto"`` on a symmetric batch) or from the legacy unreduced QR
iteration (``method="qr"``); ``_spectral_core`` takes eigenvalues
computed elsewhere.  ``spectral_pipeline_sharded`` runs the Schur route
on each rank's slice of the batch over a device mesh's dp axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import dispatch
from ..ops.eigen import eigvals_qr_batched, spectral_decompose_batched
from ..ops.schur import EigResult, eig_real_batched, eigvals_schur
from ..ops.symmetric import eigh_batched, is_symmetric_batched
from ..utils.precision import f32_matmuls


class SpectralReport(NamedTuple):
    eig_real: torch.Tensor        # [B, n]
    eig_imag: torch.Tensor        # [B, n]
    alg_mult: torch.Tensor        # [B, n] algebraic multiplicity per slot
    geom_mult: torch.Tensor       # [B, n] geometric multiplicity per slot
    diagonalizable: torch.Tensor  # [B] bool
    P: torch.Tensor               # [B, n, n]
    P_inv: torch.Tensor           # [B, n, n]
    D: torch.Tensor               # [B, n, n]


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

    ``method="schur"`` (default): Francis-QR eigenvalues
    (``ops.schur.eigvals_schur``, one host read a chunk of sweeps), then
    the spectral core.  ``method="eig"``: Schur with accumulated vectors
    and strevc-style back-substitution, O(n³) eigenvectors for spectra
    of (mostly) distinct real eigenvalues; repeated eigenvalues make its
    P near-singular, which the validation flags (``diagonalizable``
    False); on success the geometric multiplicities are reported equal
    to the algebraic ones.  ``method="eigh"``: symmetric input, the
    spectral theorem's path: one direct symmetric eigensolve, P
    orthogonal (P⁻¹ = Pᵀ, no inverse solve), always diagonalizable,
    alg = geom by clustering.  ``method="qr"``, and any other string, as
    in the reference: the unreduced QR iteration (``iters`` steps), then
    the spectral core.
    ``method="auto"``: ``"eigh"`` if every matrix is numerically
    symmetric (one host read), else ``"schur"``.

    ``max_distinct`` bounds the distinct eigenvalues whose eigenspaces
    the Schur path computes (default n, exact)."""
    if method == "auto":
        method = "eigh" if bool(is_symmetric_batched(a).all()) else "schur"
    if method == "schur":
        ev = eigvals_schur(a)
        return _spectral_core(a, ev.real, ev.imag, tol,
                              max_distinct=max_distinct)
    if method == "eig":
        return _report_from_eig(a, eig_real_batched(a), tol)
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


def _report_from_eig(a: torch.Tensor, res: EigResult,
                     tol: float) -> SpectralReport:
    """SpectralReport from an O(n³) eigendecomposition: slots sorted by
    descending real part (the columns of V gathered along), P validated
    by its inverse residual; P⁻¹ from ``dispatch.inverse_batched(auto)``
    on P, or on I where a lane has not converged or lacks a real
    eigenvector."""
    B, n, _ = a.shape
    dtype = res.vectors.dtype
    order = torch.argsort(-res.real, dim=1, stable=True)
    lam = res.real.to(dtype).gather(1, order)
    lam_im = res.imag.to(dtype).gather(1, order)
    P = res.vectors.gather(2, order[:, None, :].expand(B, n, n))
    valid_s = res.valid.gather(1, order)
    dr = lam[:, :, None] - lam[:, None, :]
    di = lam_im[:, :, None] - lam_im[:, None, :]
    alg = (dr * dr + di * di <= tol * tol).sum(2).to(torch.int32)
    ok = res.converged & valid_s.all(1)
    eye = torch.eye(n, dtype=dtype, device=a.device)
    P_safe = torch.where(ok[:, None, None], P, eye)
    P_inv = dispatch.inverse_batched(P_safe, backend="auto")
    with f32_matmuls():
        resid = (P_safe @ P_inv - eye).abs().amax((1, 2))
        D = P_inv @ a.to(dtype) @ P_safe
    ok = ok & torch.isfinite(resid) & (resid < max(1e-2, 3.0 * tol))
    geom = torch.where(ok[:, None], alg, 0)
    return SpectralReport(lam, lam_im, alg, geom, ok, P_safe, P_inv, D)


def _spectral_pipeline_qr(a: torch.Tensor, iters: int = 100,
                          tol: float = 1e-3) -> SpectralReport:
    ev = eigvals_qr_batched(a, iters=iters)
    return _spectral_core(a, ev.real, ev.imag, tol)


def spectral_pipeline_sharded(a: torch.Tensor, mesh, tol: float = 1e-3,
                              max_distinct: Optional[int] = None
                              ) -> SpectralReport:
    """``spectral_pipeline`` over a ``("dp", "tp")`` device mesh with the
    batch sharded over dp: every rank takes its slice of the global
    ``a [B, n, n]`` (the same on every rank), runs the Schur eigenvalues
    (``eigvals_schur``: the chase and window kernels) and the
    multiplicities and diagonalization core (``_spectral_core``) on it,
    with no collective, and returns the report of its slice.  ``B`` must
    divide by the dp axis."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..parallel.mesh import axis_size, shard_batch

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh "
                        f"(parallel.mesh.make_mesh), not "
                        f"{type(mesh).__name__}")
    B = a.shape[0]
    dp = axis_size(mesh, "dp")
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    a = shard_batch(a, mesh)
    ev = eigvals_schur(a)
    return _spectral_core(a, ev.real, ev.imag, tol, max_distinct=max_distinct)
