"""Batched SVD by QDWH polar decomposition and a symmetric eigensolve
(counterpart of ``linalg_solver_tpu.ops.svd``).

1. **QDWH** (dynamically weighted Halley, Nakatsukasa–Bai–Gygi): the
   polar factor ``A = U_p H`` from a fixed number of rational iterations
   ``X ← X(aI + bXᵀX)(I + cXᵀX)⁻¹``, each one batched Gram product, one
   batched Cholesky and two triangular solves.
2. **eigh** of the symmetric PSD ``H = U_pᵀA``: ``H = VΣVᵀ``, then
   ``U = U_p V``.

The reference's algorithm, not the library's bidiagonalization, so that
results stay comparable.  Two departures, both in rounding only:

- ``_qdwh_coeffs``'s cube root: torch has no ``cbrt``; the port takes the
  sign-safe real cube root ``sign(x)·|x|^(1/3)`` in float64 and rounds
  it to float32 (within an ulp of the reference's float32 ``cbrt``).
- ``H``'s eigendecomposition runs in float64 and is rounded, the route of
  ``ops.symmetric.eigh_batched``: the library's float32 ``eigh`` on an
  H100 is too inaccurate (see there).  A lane whose ``H`` is not finite
  gets NaN, as from ``jnp.linalg.eigh``, where torch's ``eigh`` raises.
- On the card each step's Gram product ``XᵀX`` is summed in float64 and
  rounded (``_gram``): there the float32 product's rounding over the long
  dimension set the polar factor's error, and TLS's x on 32 lanes of
  ``[768, 257]`` missed the reference test's 2e-4 (3.13e-4, the median lane
  1.17e-4 against 5.07e-5 on a CPU; 6.45e-5 with the float64 Gram; NVIDIA
  H100 80GB HBM3, 700 W, ``tests/test_torch_matfun_probe.py``).  On the
  CPU the float32 product keeps the reference's rounding.

f32 conditioning: the iteration factors ``Z = I + c·XᵀX`` whose
condition is ~``c``; the weighting starts from the clamped lower bound
``l₀ = 1e-3`` so that the first factor stays within f32 Cholesky range,
and the fixed ``iters=8`` covers the extra iterations the clamp costs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls
from .spd import cholesky_or_nan
from .symmetric import eigh_batched


class SVDResult(NamedTuple):
    """Thin SVD ``a = U @ diag(s) @ Vᵀ`` with ``s`` descending."""

    U: torch.Tensor   # [B, m, k]  (k = min(m, n))
    s: torch.Tensor   # [B, k]     descending, ≥ 0
    V: torch.Tensor   # [B, n, k]
    ok: torch.Tensor  # [B]        iteration stayed finite


def _real_cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root of a float32 tensor: ``sign(x)·|x|^(1/3)`` in float64,
    rounded (torch has no ``cbrt``)."""
    x64 = x.to(torch.float64)
    return (torch.sign(x64) * x64.abs().pow(1.0 / 3.0)).to(x.dtype)


def _qdwh_coeffs(l):
    """Per-lane dynamic Halley weights (a, b, c) and the updated lower
    bound, from the current σ-interval lower bound ``l`` ∈ (0, 1]."""
    l2 = l * l
    d = _real_cbrt(4.0 * (1.0 - l2) / (l2 * l2))
    h = torch.sqrt(1.0 + d)
    inner = 8.0 - 4.0 * d + 8.0 * (2.0 - l2) / (l2 * h)
    a = h + 0.5 * torch.sqrt(torch.clamp(inner, min=0.0))
    b = (a - 1.0) ** 2 / 4.0
    c = a + b - 1.0
    l_new = l * (a + b * l2) / (1.0 + c * l2)
    return a, b, c, torch.clamp(l_new, max=1.0)


def _gram(x: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` of a batch; on the card summed in float64 and rounded to
    X's dtype."""
    if not x.is_cuda:
        return x.transpose(1, 2) @ x
    xd = x.to(torch.float64)
    return (xd.transpose(1, 2) @ xd).to(x.dtype)


def _qdwh_polar(x: torch.Tensor, l0: float, iters: int):
    """Orthogonal polar factor of a scaled tall batch (σmax ≲ 1), the
    Cholesky variant: ``X⁺ = (b/c)X + (a − b/c)·X(I + cXᵀX)⁻¹``."""
    bsz, _, n = x.shape
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    l = torch.full((bsz,), l0, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        a, b, c, l = _qdwh_coeffs(l)
        W = cholesky_or_nan(eye + c[:, None, None] * _gram(x))
        # Y = X Z⁻¹ (Z = W Wᵀ): Yᵀ = W⁻ᵀ W⁻¹ Xᵀ
        y = torch.linalg.solve_triangular(W, x.transpose(1, 2), upper=False)
        y = torch.linalg.solve_triangular(W.transpose(1, 2), y, upper=True)
        x = (b / c)[:, None, None] * x + (a - b / c)[:, None, None] * (
            y.transpose(1, 2))
    return x, torch.isfinite(x).all(dim=(1, 2))


class PolarResult(NamedTuple):
    """Polar decomposition ``a = up @ H`` (H symmetric PSD)."""

    up: torch.Tensor  # [B, m, n] orthogonal (partial isometry for m > n)
    H: torch.Tensor   # [B, n, n]
    ok: torch.Tensor  # [B]


@f32_matmuls()
def polar_batched(a: torch.Tensor, iters: int = 8) -> PolarResult:
    """Polar decomposition of a batched ``[B, m, n]`` matrix (m ≥ n): the
    QDWH iteration exposed directly (orthogonal Procrustes, nearest
    orthogonal matrix, matrix sign)."""
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    n1 = a.abs().sum(dim=1).amax(dim=1)
    ninf = a.abs().sum(dim=2).amax(dim=1)
    alpha = torch.clamp(torch.sqrt(n1 * ninf), min=1e-30)
    up, ok = _qdwh_polar(a / alpha[:, None, None], l0=1e-3, iters=iters)
    H = up.transpose(1, 2) @ a
    return PolarResult(up, 0.5 * (H + H.transpose(1, 2)), ok)


@f32_matmuls()
def _svd_impl(a: torch.Tensor, iters: int):
    pol = polar_batched(a, iters=iters)
    # H = U_pᵀ A is symmetric PSD up to roundoff; its eigh gives V and Σ
    finite = torch.isfinite(pol.H).all(dim=(1, 2))
    res = eigh_batched(torch.where(finite[:, None, None], pol.H, 0.0))
    w = torch.where(finite[:, None], res.w, torch.nan)
    V = torch.where(finite[:, None, None], res.V, torch.nan).flip(-1)
    s = torch.clamp(w.flip(-1), min=0.0)       # descending, clamp -eps
    return pol.up @ V, s, V, pol.ok


class _SVD(torch.autograd.Function):
    """Thin SVD of a tall batch with the classical thin-SVD adjoint (V
    square, so the right null-space term vanishes)."""

    @staticmethod
    def forward(ctx, a, iters):
        U, s, V, ok = _svd_impl(a, iters)
        ctx.mark_non_differentiable(ok)
        ctx.save_for_backward(U, s, V)
        return U, s, V, ok

    @staticmethod
    @f32_matmuls()
    def backward(ctx, gU, gs, gV, _):
        U, s, V = ctx.saved_tensors
        _, m, n = U.shape
        eps = torch.finfo(U.dtype).eps
        eye = torch.eye(n, dtype=U.dtype, device=U.device)
        den = s[:, None, :] ** 2 - s[:, :, None] ** 2
        tiny = n * eps * torch.clamp(s[:, 0] ** 2, min=1e-30)[:, None, None]
        F = torch.where(den.abs() > tiny,
                        1.0 / torch.where(den == 0, 1.0, den), 0.0)
        F = F * (1.0 - eye)
        J = F * (U.transpose(1, 2) @ gU)
        K = F * (V.transpose(1, 2) @ gV)
        inner = (gs[:, :, None] * eye
                 + (J + J.transpose(1, 2)) * s[:, None, :]
                 + (K + K.transpose(1, 2)) * s[:, :, None])
        abar = U @ inner @ V.transpose(1, 2)
        # the left null-space term (I − UUᵀ) Ū Σ⁻¹ Vᵀ, zero when m == n
        if m > n:
            tiny_s = n * eps * torch.clamp(s[:, :1], min=1e-30)
            sinv = torch.where(s > tiny_s,
                               1.0 / torch.clamp(s, min=1e-30), 0.0)
            GsV = gU * sinv[:, None, :]
            proj = GsV - U @ (U.transpose(1, 2) @ GsV)
            abar = abar + proj @ V.transpose(1, 2)
        return abar, None


def svd_batched(a: torch.Tensor, iters: int = 8) -> SVDResult:
    """Thin SVD of a batched real matrix ``[B, m, n]`` (any shape; a wide
    batch goes through its transpose).

    Differentiable through ``_SVD``: ``Ā = U [diag(s̄) + (J+Jᵀ)Σ +
    Σ(K+Kᵀ)] Vᵀ + (I − UUᵀ) Ū Σ⁻¹ Vᵀ`` with ``J = F ∘ (Uᵀ Ū)``,
    ``K = F ∘ (Vᵀ V̄)``, ``F_ij = 1/(s_j² − s_i²)``; near-equal pairs (gap
    ≤ n·eps·σmax²) contribute zero instead of blowing up, so σ gradients
    stay exact there and singular-vector gradients are defined only for
    simple singular values."""
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    if a.shape[1] < a.shape[2]:
        U, s, V, ok = _SVD.apply(a.transpose(1, 2), iters)
        return SVDResult(V, s, U, ok)
    return SVDResult(*_SVD.apply(a, iters))


@f32_matmuls()
def pinv_batched(
    a: torch.Tensor, rcond: Optional[float] = None, iters: int = 8
) -> torch.Tensor:
    """Moore–Penrose pseudoinverse ``[B, n, m]`` (numpy semantics:
    singular values ≤ rcond·σmax count as zero; default rcond
    ``max(m, n)·eps``)."""
    _, m, n = a.shape
    if rcond is None:
        rcond = max(m, n) * torch.finfo(torch.float32).eps
    res = svd_batched(a, iters=iters)
    sinv = torch.where(res.s > rcond * res.s[:, :1],
                       1.0 / torch.clamp(res.s, min=1e-30), 0.0)
    return (res.V * sinv[:, None, :]) @ res.U.transpose(1, 2)


def cond2_batched(a: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """[B] spectral condition number σmax/σmin (inf where σmin ≈ 0)."""
    res = svd_batched(a, iters=iters)
    smin = res.s[:, -1]
    return torch.where(smin > 0, res.s[:, 0] / torch.clamp(smin, min=1e-30),
                       torch.inf)


def rank_svd_batched(
    a: torch.Tensor, tol: Optional[float] = None, iters: int = 8
) -> torch.Tensor:
    """[B] numerical rank by singular-value thresholding (the robust oracle
    for the elimination-based ``ops.solve.rank_batched``)."""
    _, m, n = a.shape
    res = svd_batched(a, iters=iters)
    if tol is None:
        tol_arr = max(m, n) * torch.finfo(res.s.dtype).eps * res.s[:, :1]
    else:
        tol_arr = torch.full_like(res.s[:, :1], tol)
    return (res.s > tol_arr).sum(dim=1).to(torch.int32)
