"""Batched fitting and regression (counterpart of
``linalg_solver_tpu.ops.fitting``), compositions of the port's solvers:

- ``ridge_batched``: Tikhonov least squares through the SPD normal
  equations ``(AᵀA + λI) x = Aᵀb`` (Cholesky, ``ops.spd``);
- ``tls_batched``: total least squares, the right singular vector of
  ``[A | b]`` for the smallest singular value (``ops.svd``), with the
  solvability condition σ_min([A|b]) < σ_min(A) as ``ok``;
- ``procrustes_batched``: the orthogonal ``Q`` minimizing ``‖QA − B‖_F``,
  the polar factor of ``BAᵀ`` (one QDWH run), and optionally the best
  scale;
- ``subspace_angles_batched``: principal angles from the SVD of ``Q₁ᵀQ₂``
  (bases by shifted CholeskyQR, ``ops.orth``), small angles by the sine
  form (Knyazev–Argentati).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .schur import _f32


class RidgeResult(NamedTuple):
    x: torch.Tensor   # [B, n] or [B, n, k]
    ok: torch.Tensor  # [B]


@f32_matmuls()
def ridge_batched(a: torch.Tensor, b: torch.Tensor, lam) -> RidgeResult:
    """Tikhonov solve ``argmin ‖Ax − b‖² + λ‖x‖²`` (``λ`` a scalar or
    ``[B]``; ``b [B, m]`` or ``[B, m, k]``)."""
    from .spd import cholesky_solve_batched

    a = _f32(a)
    B, m, n = a.shape
    lam = torch.as_tensor(lam, dtype=a.dtype, device=a.device).expand(B)
    vector_input = b.dim() == 2
    b3 = (b[:, :, None] if vector_input else b).to(a.dtype)
    gram = a.transpose(1, 2) @ a + lam[:, None, None] * torch.eye(
        n, dtype=a.dtype, device=a.device)
    x, ok = cholesky_solve_batched(gram, a.transpose(1, 2) @ b3)
    return RidgeResult(x[:, :, 0] if vector_input else x, ok)


class TLSResult(NamedTuple):
    x: torch.Tensor      # [B, n]
    ok: torch.Tensor     # [B] solvable (a genuine σ gap, x finite)
    sigma: torch.Tensor  # [B] smallest singular value of [A | b]


@f32_matmuls()
def tls_batched(a: torch.Tensor, b: torch.Tensor) -> TLSResult:
    """Total least squares: the smallest perturbation of both A and b that
    makes ``(A + ΔA) x = b + Δb`` consistent; with ``v`` the right
    singular vector of ``[A | b]`` for σ_min, ``x = −v[:n] / v[n]``."""
    from .svd import svd_batched

    a = _f32(a)
    n = a.shape[2]
    svd = svd_batched(torch.cat([a, b[:, :, None].to(a.dtype)], dim=2))
    v = svd.V[:, :, n]                  # right vector for σ_min
    sig = svd.s[:, n]
    denom = v[:, n]
    ok = (denom.abs() > torch.finfo(a.dtype).eps * 100.0) & svd.ok
    x = -v[:, :n] / torch.where(ok, denom, 1.0)[:, None]
    # solvable: σ_min([A|b]) strictly below σ_min(A)
    ok = ok & (sig < svd_batched(a).s[:, n - 1] * (1.0 - 1e-5))
    return TLSResult(x, ok, sig)


class ProcrustesResult(NamedTuple):
    Q: torch.Tensor      # [B, n, n] orthogonal
    scale: torch.Tensor  # [B] optimal scale (1.0 unless with_scale)
    ok: torch.Tensor     # [B]


@f32_matmuls()
def procrustes_batched(a: torch.Tensor, b: torch.Tensor,
                       with_scale: bool = False) -> ProcrustesResult:
    """Orthogonal Procrustes: the orthogonal ``Q`` minimizing
    ``‖Q A − B‖_F`` is the polar factor of ``B Aᵀ`` (one QDWH run, no
    SVD); ``with_scale`` also returns the best scalar ``s`` for
    ``‖s·QA − B‖_F``, ``tr(H)/‖A‖²_F``."""
    from .svd import polar_batched

    a, b = _f32(a), _f32(b)
    pol = polar_batched(b @ a.transpose(1, 2))
    if with_scale:
        num = pol.H.diagonal(0, 1, 2).sum(dim=1)
        scale = num / torch.clamp((a * a).sum(dim=(1, 2)), min=1e-30)
    else:
        scale = torch.ones(a.shape[0], dtype=a.dtype, device=a.device)
    return ProcrustesResult(pol.up, scale, pol.ok)


class SubspaceAngles(NamedTuple):
    angles: torch.Tensor  # [B, k] radians, ascending
    ok: torch.Tensor      # [B]


@f32_matmuls()
def subspace_angles_batched(u: torch.Tensor, v: torch.Tensor
                            ) -> SubspaceAngles:
    """Principal angles between span(u) and span(v) (``u [B, n, p]``,
    ``v [B, n, q]``, k = min(p, q)).  Cosines from the SVD of Q₁ᵀQ₂;
    where the cosine exceeds 0.99 the angle comes from the sines, the
    singular values of (I − Q₁Q₁ᵀ)Q₂, which keep small angles at full
    precision where ``acos(1 − ε)`` loses them."""
    from .orth import orthonormal_columns
    from .svd import svd_batched

    dtype = torch.promote_types(u.dtype, torch.float32)
    B, n, p = u.shape
    q = v.shape[2]
    k = min(p, q)

    def orth(x):
        nc = x.shape[2]
        X = torch.cat([x.to(dtype), torch.zeros(B, n, n - nc, dtype=dtype,
                                                device=x.device)], dim=2)
        gmask = torch.arange(n, device=x.device)[None, :].expand(B, n) < nc
        Q, _ = orthonormal_columns(X, gmask)
        return Q[:, :, :nc]

    Q1, Q2 = orth(u), orth(v)
    m = Q1.transpose(1, 2) @ Q2
    sv = svd_batched(m)
    cos = torch.clamp(sv.s[:, :k], 0.0, 1.0)
    sv_sin = svd_batched(Q2 - Q1 @ m)
    # cos descending ⇔ angles ascending ⇔ sines ascending: the tail of the
    # sines' singular values, reversed
    sin = torch.clamp(sv_sin.s.flip(-1)[:, :k], 0.0, 1.0)
    angles = torch.where(cos > 0.99, torch.arcsin(sin), torch.arccos(cos))
    return SubspaceAngles(angles, sv.ok & sv_sin.ok)
