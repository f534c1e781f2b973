"""Batched least-squares and minimum-norm solves of full-rank rectangular
systems (counterpart of ``linalg_solver_tpu.ops.lstsq``).

For overdetermined full-column-rank systems the least-squares minimizer,
for underdetermined full-row-rank systems the minimum-norm solution.
Rank-deficient systems stay with ``dispatch.affine_solve_batched``.

The factorization is the reference's shifted CholeskyQR2 (two passes
restore what one pass loses to the Gram matrix's squared condition):
batched Gram products, a batched Cholesky and triangular solves, no
per-column Householder loop; then ``ir_steps`` rounds of residual
refinement through the same Q and R.  A Gram factorization that fails
gives NaN in its lane (``ops.spd.cholesky_or_nan``), so ``ok`` is False
there, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.precision import f32_matmuls
from .spd import cholesky_or_nan

#: seed of ``complete_basis_batched``'s default Gaussian block (the JAX
#: package draws it from ``jax.random.PRNGKey(7)``, which torch cannot
#: reproduce: pass the block to get the reference's draw)
BASIS_SEED = 7


class LstsqResult(NamedTuple):
    x: torch.Tensor      # [B, n] or [B, n, k]: minimizer / minimum norm
    resid: torch.Tensor  # [B] or [B, k] ‖a@x − b‖₂ (0 when consistent)
    ok: torch.Tensor     # [B] Gram factorization succeeded (full rank
    #                      within the shift's resolution; False lanes
    #                      carry NaNs: route them to affine_solve)


def _chol_qr2_tall(a: torch.Tensor):
    """Shifted CholeskyQR2 of a tall ``[B, m, n]`` batch (m ≥ n): returns
    ``(Q [B, m, n]`` orthonormal, ``R [B, n, n]`` upper, ``ok [B])``."""
    _, m, n = a.shape
    eps = torch.finfo(a.dtype).eps
    eye = torch.eye(n, dtype=a.dtype, device=a.device)

    def one_pass(g, shift):
        gram = g.transpose(1, 2) @ g
        if shift:
            scale = gram.diagonal(dim1=1, dim2=2).sum(dim=1)[:, None, None]
            gram = gram + shift * scale * eye
        L = cholesky_or_nan(gram)
        qt = torch.linalg.solve_triangular(L, g.transpose(1, 2), upper=False)
        return qt.transpose(1, 2), L

    # column pre-scaling bounds the shifted pass's Gram condition
    d = torch.clamp(torch.sqrt((a * a).sum(dim=1)), min=1e-30)
    Q, L1 = one_pass(a / d[:, None, :], 16.0 * max(m, n) * eps)
    Q, L2 = one_pass(Q, 0.0)
    ok = torch.isfinite(Q).all(dim=(1, 2))
    # a = Q R with R = L2ᵀ L1ᵀ diag(d)
    R = (L2.transpose(1, 2) @ L1.transpose(1, 2)) * d[:, None, :]
    return Q, R, ok


def _lower_solve(R: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``Rᵀ z = rhs`` for upper-triangular R."""
    return torch.linalg.solve_triangular(R.transpose(1, 2), rhs, upper=False)


def _lstsq_x_impl(a, b3, ir_steps):
    _, m, n = a.shape
    if m >= n:
        Q, R, _ = _chol_qr2_tall(a)

        def solve(rhs):
            return torch.linalg.solve_triangular(
                R, Q.transpose(1, 2) @ rhs, upper=True)
    else:
        # aᵀ = Q R, x = Q z with Rᵀ z = b (a Q = Rᵀ): x ∈ range(aᵀ)
        Q, R, _ = _chol_qr2_tall(a.transpose(1, 2))

        def solve(rhs):
            return Q @ _lower_solve(R, rhs)

    x = solve(b3)
    for _ in range(ir_steps):
        x = x + solve(b3 - a @ x)
    return x, R


def _gram_solve(R, rhs):
    """``(RᵀR)⁻¹ rhs`` from the saved upper-triangular Gram factor."""
    return torch.linalg.solve_triangular(R, _lower_solve(R, rhs), upper=True)


class _LstsqX(torch.autograd.Function):
    """x of ``lstsq_batched`` with the exact full-rank adjoints
    (Golub–Pereyra) on the saved Gram factor."""

    @staticmethod
    def forward(ctx, a, b3, ir_steps):
        x, R = _lstsq_x_impl(a, b3, ir_steps)
        ctx.save_for_backward(a, b3, x, R)
        return x

    @staticmethod
    @f32_matmuls()
    def backward(ctx, g):
        a, b3, x, R = ctx.saved_tensors
        m, n = a.shape[-2:]
        if m >= n:
            z = _gram_solve(R, g)                           # (AᵀA)⁻¹ x̄
            az = a @ z
            r = b3 - a @ x
            abar = r @ z.transpose(1, 2) - az @ x.transpose(1, 2)
            return abar, az, None
        u = _gram_solve(R, a @ g)                           # (AAᵀ)⁻¹ A x̄
        w = _gram_solve(R, b3)                              # (AAᵀ)⁻¹ b
        atu = a.transpose(1, 2) @ u                         # Aᵀ u
        abar = w @ (g - atu).transpose(1, 2) - u @ x.transpose(1, 2)
        return abar, u, None


@f32_matmuls()
def lstsq_batched(
    a: torch.Tensor, b: torch.Tensor, ir_steps: int = 1
) -> LstsqResult:
    """Least-squares / minimum-norm solve of a full-rank batch.

    ``a [B, m, n]``, ``b [B, m]`` or ``[B, m, k]``:

    - m ≥ n (overdetermined): x = argmin ‖a@x − b‖₂ by CholeskyQR2
      (x = R⁻¹Qᵀb) and ``ir_steps`` residual-refinement rounds;
    - m < n (underdetermined): the minimum-norm solution x = Qᵣ Rᵣ⁻ᵀ b
      from the same factorization of aᵀ = QᵣRᵣ, refined the same way.

    Differentiable: ``x`` carries the exact full-rank adjoints
    (Golub–Pereyra) on the saved Gram factor: least squares,
    ``z = (AᵀA)⁻¹x̄``, ``b̄ = A z``, ``Ā = r zᵀ − (A z) xᵀ`` with
    ``r = b − A x``; minimum norm, ``u = (AAᵀ)⁻¹A x̄``, ``b̄ = u``,
    ``Ā = w (x̄ − Aᵀu)ᵀ − u xᵀ`` with ``w = (AAᵀ)⁻¹ b``."""
    vector_input = b.dim() == 2
    b3 = b[:, :, None] if vector_input else b
    f32 = torch.promote_types(a.dtype, torch.float32)
    a, b3 = a.to(f32), b3.to(f32)
    x = _LstsqX.apply(a, b3, ir_steps)
    final = b3 - a @ x
    resid = torch.sqrt((final * final).sum(dim=1))       # [B, k]
    ok = torch.isfinite(x).all(dim=(1, 2))
    if vector_input:
        return LstsqResult(x[:, :, 0], resid[:, 0], ok)
    return LstsqResult(x, resid, ok)


class QRResult(NamedTuple):
    """Thin QR ``a = Q @ R`` (Q [B, m, n] orthonormal columns, R [B, n, n]
    upper-triangular)."""

    Q: torch.Tensor
    R: torch.Tensor
    ok: torch.Tensor  # [B] factorization finite (full column rank within
    #                   the shift's resolution)


class _QR(torch.autograd.Function):
    """Thin QR by shifted CholeskyQR2 with the classical thin-QR adjoint
    for full column rank: ``M = R R̄ᵀ − Q̄ᵀ Q``,
    ``Ā = (Q̄ + Q·copyltu(M)) R⁻ᵀ``, ``copyltu`` mirroring the strict
    lower triangle onto the upper and keeping the diagonal."""

    @staticmethod
    @f32_matmuls()
    def forward(ctx, a):
        Q, R, _ = _chol_qr2_tall(a)
        ctx.save_for_backward(Q, R)
        return Q, R

    @staticmethod
    @f32_matmuls()
    def backward(ctx, gQ, gR):
        Q, R = ctx.saved_tensors
        n = R.shape[-1]
        M = R @ gR.transpose(1, 2) - gQ.transpose(1, 2) @ Q
        lo = torch.tril(M, -1)
        copyltu = lo + lo.transpose(1, 2) + M * torch.eye(
            n, dtype=M.dtype, device=M.device)
        num = gQ + Q @ copyltu
        # Ā = num R⁻ᵀ  ⇔  Āᵀ = R⁻¹ numᵀ
        return torch.linalg.solve_triangular(
            R, num.transpose(1, 2), upper=True).transpose(1, 2)


def qr_batched(a: torch.Tensor) -> QRResult:
    """Thin QR of a batched ``[B, m, n]`` matrix with m ≥ n: shifted
    CholeskyQR2, differentiable through ``_QR``'s adjoint."""
    _, m, n = a.shape
    if m < n:
        raise ValueError(
            f"qr_batched needs m >= n (thin QR); got {m}x{n}. "
            "Factor the transpose (a = (R^T)(Q^T)) for wide input.")
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    Q, R = _QR.apply(a)
    return QRResult(Q, R, torch.isfinite(Q).all(dim=(1, 2)))


@f32_matmuls()
def complete_basis_batched(
    u: torch.Tensor, g: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Orthonormal complement of orthonormal columns ``u [B, m, k]``
    (k < m): ``[B, m, m − k]`` with ``[u | complement]`` an orthonormal
    basis of Rᵐ.

    A fixed Gaussian block ``g [m, m − k]`` is projected onto
    ``range(u)^⊥`` and orthonormalized by shifted CholeskyQR2, twice (the
    second round pins the orthogonality and the ``uᵀq = 0`` defect at
    the f32 floor).  ``g`` defaults to a draw from a CPU
    ``torch.Generator`` seeded with ``BASIS_SEED``, moved to ``u``'s
    device; the reference's draw is another one, so tests pass it in."""
    bsz, m, k = u.shape
    f32 = torch.promote_types(u.dtype, torch.float32)
    u = u.to(f32)
    if g is None:
        g = torch.randn((m, m - k), generator=torch.Generator().manual_seed(
            BASIS_SEED), dtype=f32)
    w = g.to(device=u.device, dtype=f32).expand(bsz, m, m - k)
    for _ in range(2):
        w = w - u @ (u.transpose(1, 2) @ w)
        w, _, _ = _chol_qr2_tall(w)
    return w
