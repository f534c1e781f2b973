"""Batched ε-pseudospectra: ``σmin(A − zI)`` over a complex grid
(counterpart of ``linalg_solver_tpu.ops.pseudospectra``).

Trefethen's algorithm (*Computation of Pseudospectra*, Acta Numerica
1999): one real Schur form a matrix (``balance=False``: a unitary
similarity, so ``σmin(A − zI) = σmin(T − zI)``), ``rsf2csf`` to a complex
upper-triangular ``T``, then at each grid point inverse power iteration
on ``(MᴴM)⁻¹`` with ``M = T − zI``: a step is one forward substitution
with ``Mᴴ`` and one back-substitution with ``M``, O(n²) a point.

The reference scans the rows on the device with the batch under ``vmap``;
here the two substitutions are Python row loops over ``[B, G]``-wide
complex tensors (the batch folded into the lanes), with every pivot's
floored reciprocal formed before the loop: a row is one batched
matrix-vector product, a subtraction, a product and a column store.
The inverse iteration's start is an argument (``u0``, or a
``torch.Generator``; ``utils.draws``): the reference draws it with
``jax.random`` and ``PRNGKey(0)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import draws
from ..utils.precision import f32_matmuls
from .ordschur import _complex_schur
from .schur import _f32, real_schur_vectors


class PseudospectraResult(NamedTuple):
    sigmin: torch.Tensor     # [B, G] σmin(A − z_g I) at each grid point
    converged: torch.Tensor  # [B] the Schur iteration converged
    ok: torch.Tensor         # [B] clean Schur form (no forced deflations)


def _pivots(t: torch.Tensor, z: torch.Tensor):
    """Reciprocals ``[B, G, n]`` of the pivots ``T_ii − z``, each floored
    (LAPACK dlatrs style) at ``eps·(max|T_re| + |T_im| + |z|)``: at a grid
    point on an eigenvalue the pivot is exactly zero, and the floor keeps
    the resolvent's blow-up visible (σmin ≈ eps·‖T − zI‖, the attainable
    answer) where a guarded divide would hide it."""
    rdt = t.real.dtype
    tnorm = (t.real.abs() + t.imag.abs()).amax(dim=(1, 2))       # [B]
    dfloor = torch.finfo(rdt).eps * (tnorm[:, None] + z.abs()[None, :])
    d = t.diagonal(0, 1, 2)[:, None, :] - z[None, :, None]      # [B, G, n]
    mag = d.abs()
    small = mag < dfloor[:, :, None]
    grow = torch.where(small, dfloor[:, :, None]
                       / torch.clamp(mag, min=torch.finfo(rdt).tiny), 1.0)
    d = torch.where(small & (mag == 0),
                    dfloor[:, :, None].to(d.dtype), d * grow)
    den = torch.clamp(d.real * d.real + d.imag * d.imag,
                      min=torch.finfo(rdt).tiny)
    return d.conj() / den


def _solve_upper(t, rp, b):
    """Back-substitution ``(T − zI) x = b`` for every lane and point:
    ``t [B, n, n]``, ``rp``/``b [B, G, n]``."""
    x = torch.zeros_like(b)
    n = t.shape[-1]
    for i in range(n - 1, -1, -1):
        s = (x[:, :, i + 1:] @ t[:, i, i + 1:, None])[:, :, 0]
        x[:, :, i] = (b[:, :, i] - s) * rp[:, :, i]
    return x


def _solve_lower_h(t, rp, b):
    """Forward substitution ``(T − zI)ᴴ y = b``: row i of the adjoint is
    ``conj(T[:, i])`` and its pivot ``conj(T_ii − z)``."""
    y = torch.zeros_like(b)
    n = t.shape[-1]
    for i in range(n):
        s = (y[:, :, :i] @ t[:, :i, i, None].conj())[:, :, 0]
        y[:, :, i] = (b[:, :, i] - s) * rp[:, :, i].conj()
    return y


@f32_matmuls()
def _sigmin_core(t: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """σmin(T − zI) ``[B, G]`` for complex upper-triangular ``t [B, n, n]``
    at points ``z [G]`` from the start ``u [G, n]`` (the same for every
    lane, as in the reference): power iteration on ``M⁻¹M⁻ᴴ``, whose
    largest eigenvalue is σmin⁻²."""
    rdt = t.real.dtype
    tiny = torch.finfo(rdt).tiny
    rp = _pivots(t, z)
    nrm0 = torch.sqrt((u.real ** 2 + u.imag ** 2).sum(dim=1))
    u = u / torch.clamp(nrm0, min=1e-30)[:, None]
    u = u.expand(t.shape[0], *u.shape).clone()
    lam = torch.zeros(u.shape[:2], dtype=rdt, device=t.device)
    for _ in range(iters):
        w = _solve_upper(t, rp, _solve_lower_h(t, rp, u))
        lam = torch.sqrt((w.real * w.real + w.imag * w.imag).sum(dim=2))
        u = w / torch.clamp(lam, min=tiny)[:, :, None]
    return 1.0 / torch.sqrt(torch.clamp(lam, min=tiny))


def sigmin_points_batched(
    a: torch.Tensor, z_re, z_im, iters: int = 20, u0=None,
    generator: Optional[torch.Generator] = None,
) -> PseudospectraResult:
    """``σmin(A − z_g I)`` for a batch of real matrices ``[B, n, n]`` at G
    complex points (``z_re``/``z_im`` ``[G]``, shared by the batch): one
    Schur form a lane, then O(n²) a point a step.  The iteration starts
    from ``u0 = (u_re, u_im)`` ``[G, n]`` (tensors or numpy arrays, e.g.
    the reference's draw), else from a standard normal draw on
    ``generator``."""
    a = _f32(a)
    dtype, dev = a.dtype, a.device
    z_re = torch.atleast_1d(torch.as_tensor(z_re, dtype=dtype, device=dev))
    z_im = torch.atleast_1d(torch.as_tensor(z_im, dtype=dtype, device=dev))
    G, n = z_re.shape[0], a.shape[-1]
    u_re, u_im = draws.start((G, n), dtype, dev, u0, generator, parts=2)
    sv = real_schur_vectors(a, balance=False)
    t, _ = _complex_schur(sv.T, sv.Q)
    sig = _sigmin_core(t, torch.complex(z_re, z_im),
                       torch.complex(u_re, u_im), iters)
    return PseudospectraResult(sig, sv.converged, sv.clean)


def pseudospectrum_grid_batched(
    a: torch.Tensor, re_pts, im_pts, iters: int = 20, u0=None,
    generator: Optional[torch.Generator] = None,
) -> PseudospectraResult:
    """σmin over the tensor grid ``re_pts × im_pts``; ``sigmin`` comes back
    as ``[B, len(im_pts), len(re_pts)]`` for a contour plot
    (``contour(re, im, sigmin[b], levels=[eps])`` draws ∂Λ_ε).  ``u0``
    holds one start a grid point, row-major over ``(im, re)``."""
    dev = a.device
    re_pts = torch.atleast_1d(torch.as_tensor(re_pts, device=dev))
    im_pts = torch.atleast_1d(torch.as_tensor(im_pts, device=dev))
    I, R = torch.meshgrid(im_pts, re_pts, indexing="ij")
    res = sigmin_points_batched(a, R.reshape(-1), I.reshape(-1), iters=iters,
                                u0=u0, generator=generator)
    return PseudospectraResult(
        res.sigmin.reshape(a.shape[0], im_pts.shape[0], re_pts.shape[0]),
        res.converged, res.ok)
