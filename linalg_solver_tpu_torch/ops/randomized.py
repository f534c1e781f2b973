"""Randomized low-rank factorizations (Halko–Martinsson–Tropp), the
interpolative decomposition and CUR (counterpart of
``linalg_solver_tpu.ops.randomized``).

Everything is batched products, a rank-revealing orthonormalization
(eigh of the Gram with the directions below its roundoff floor dropped,
then one Cholesky refinement) and the small core's QDWH SVD
(``ops.svd``):

    Y = (A Aᵀ)^q · A · Ω     (Ω Gaussian [n, k+p]; q power iterations)
    Q = orth(Y)
    B = Qᵀ A                 ([k+p, n] core)
    B = Ũ Σ Vᵀ  ⇒  A ≈ (QŨ)[:, :k] Σ[:k] V[:, :k]ᵀ

The reference draws Ω and the residual probes from ``PRNGKey(0)``; here
they are the optional ``omega`` / ``probes`` arguments (a caller can hand
over the reference's draws), else standard normal draws on a
``torch.Generator`` (``utils.draws``).  The ID and CUR pick columns and
rows by the pivoted Cholesky of the Gram (``ops.spd``) and fit the rest
by least squares (``ops.lstsq``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import draws
from ..utils.precision import f32_matmuls
from .lstsq import lstsq_batched
from .spd import cholesky_or_nan, pivoted_cholesky_batched
from .svd import svd_batched
from .symmetric import eigh_batched


class RandomizedSVD(NamedTuple):
    U: torch.Tensor          # [B, m, k]
    s: torch.Tensor          # [B, k] descending
    V: torch.Tensor          # [B, n, k]
    resid_est: torch.Tensor  # [B] sampled ‖A − U diag(s) Vᵀ‖₂ estimate
    ok: torch.Tensor         # [B]
    #: [B, k] True where the component carries signal (k past the input's
    #: numerical rank gives trailing False columns, s ~ 0)
    valid: Optional[torch.Tensor] = None


def _orth_rank_revealing(Y: torch.Tensor):
    """Orthonormal basis of range(Y), robust to a rank-deficient Y: eigh
    of the Gram, the directions above ``4·eps·w_max`` kept (zero columns
    elsewhere), then one Cholesky refinement with the dropped columns'
    Gram diagonal patched to 1."""
    _, _, ell = Y.shape
    dtype = Y.dtype
    eps = torch.finfo(dtype).eps
    eye = torch.eye(ell, dtype=dtype, device=Y.device)
    gram = Y.transpose(1, 2) @ Y
    eig = eigh_batched(gram)
    w, P = eig.w, eig.V
    wmax = torch.clamp(w[:, -1:], min=torch.finfo(dtype).tiny)
    valid = w > (4.0 * eps) * wmax                              # [B, ell]
    scale = torch.where(valid, 1.0 / torch.sqrt(torch.clamp(w, min=1e-30)),
                        0.0)
    Q = Y @ (P * scale[:, None, :])
    validf = valid.to(dtype)
    g2 = Q.transpose(1, 2) @ Q
    g2 = (g2 * validf[:, :, None] * validf[:, None, :]
          + (1.0 - validf)[:, None, :] * eye[None])
    L = cholesky_or_nan(g2)
    Q = torch.linalg.solve_triangular(
        L, Q.transpose(1, 2), upper=False).transpose(1, 2) * validf[:, None, :]
    ok = torch.isfinite(Q).all(dim=2).all(dim=1)
    return Q, ok


@f32_matmuls()
def randomized_svd_batched(a: torch.Tensor, k: int, oversample: int = 8,
                           power_iters: int = 2,
                           omega: Optional[torch.Tensor] = None,
                           probes: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> RandomizedSVD:
    """Rank-k randomized SVD of a batched ``[B, m, n]`` matrix.

    ``omega [B, n, k + oversample]`` (clipped to min(m, n) columns) and
    ``probes [B, n, 4]`` are the Gaussian sketch and the residual probes;
    by default both are drawn on ``generator`` (one on a's device seeded
    ``draws.SEED``), Ω first."""
    B, m, n = a.shape
    ell = min(k + oversample, min(m, n))
    if k > min(m, n):
        raise ValueError(f"k={k} exceeds min(m, n)={min(m, n)}")
    f32 = torch.promote_types(a.dtype, torch.float32)
    a = a.to(f32)
    if generator is None and (omega is None or probes is None):
        generator = torch.Generator(device=a.device).manual_seed(draws.SEED)
    (omega,) = draws.start((B, n, ell), f32, a.device, given=omega,
                           generator=generator)
    (w,) = draws.start((B, n, 4), f32, a.device, given=probes,
                       generator=generator)

    Y = a @ omega
    ok = torch.ones(B, dtype=torch.bool, device=a.device)
    for _ in range(power_iters):
        # orthonormalize between applications: powers of A squash the
        # sample basis onto the top singular direction otherwise
        Q, okq = _orth_rank_revealing(Y)
        Z = a.transpose(1, 2) @ Q
        Qz, okz = _orth_rank_revealing(Z)
        ok = ok & okq & okz
        Y = a @ Qz
    Q, okq = _orth_rank_revealing(Y)
    ok = ok & okq

    core = svd_batched(Q.transpose(1, 2) @ a)             # [B, ell, n] thin
    U = Q @ core.U[:, :, :k]
    s = core.s[:, :k]
    V = core.V[:, :, :k]

    # a sampled spectral-norm estimate of the truncation error
    w = w / torch.clamp(torch.sqrt((w * w).sum(dim=1, keepdim=True)),
                        min=1e-30)
    Aw = a @ w
    low = U @ (s[:, :, None] * (V.transpose(1, 2) @ w))
    resid = torch.sqrt(((Aw - low) ** 2).sum(dim=1).amax(dim=1))
    eps = torch.finfo(f32).eps
    # the rank floor scales with the sample width (the source of spurious
    # tiny values), not with the matrix dimensions
    valid = s > (ell * eps) * torch.clamp(s[:, :1], min=1e-30)
    return RandomizedSVD(U, s, V, resid, ok & core.ok, valid)


class InterpolativeDecomposition(NamedTuple):
    """Column ID ``A ≈ A[:, cols] @ X``: the k most informative columns
    (in greedy selection order) and the interpolation coefficients;
    ``resid_fro`` is the relative Frobenius error of the reconstruction."""

    cols: torch.Tensor       # [B, k] int32
    X: torch.Tensor          # [B, k, n]
    resid_fro: torch.Tensor  # [B]
    ok: torch.Tensor         # [B]


class CURDecomposition(NamedTuple):
    """``A ≈ C @ U @ R`` from columns and rows of A: ``C = A[:, cols]``,
    ``R = A[rows, :]``, U [B, k, k]."""

    cols: torch.Tensor       # [B, k] int32
    rows: torch.Tensor       # [B, k] int32
    C: torch.Tensor          # [B, m, k]
    U: torch.Tensor          # [B, k, k]
    R: torch.Tensor          # [B, k, n]
    resid_fro: torch.Tensor  # [B]
    ok: torch.Tensor         # [B]


def _select_columns_gram(a: torch.Tensor, k: int):
    """Greedy column selection: the diagonal-pivoted Cholesky of AᵀA (the
    pivot order of column-pivoted QR on A)."""
    pc = pivoted_cholesky_batched(a.transpose(1, 2) @ a, max_rank=k)
    return pc.piv, pc.ok


def _gather_cols(a: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``[B, m, k]``: the chosen columns (a gather, where the reference
    multiplies by a one-hot matrix)."""
    idx = cols.to(torch.int64)[:, None, :].expand(-1, a.shape[1], -1)
    return torch.gather(a, 2, idx)


def _rel_fro(a: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    err = torch.sqrt(((a - rec) ** 2).sum(dim=(1, 2)))
    return err / torch.clamp(torch.sqrt((a * a).sum(dim=(1, 2))), min=1e-30)


@f32_matmuls()
def interpolative_batched(a: torch.Tensor, k: int
                          ) -> InterpolativeDecomposition:
    """Rank-k column interpolative decomposition of ``[B, m, n]``: k
    columns by the Gram's pivoted Cholesky, the rest by least squares
    (CholeskyQR2 + refinement)."""
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    cols, ok = _select_columns_gram(a, k)
    C = _gather_cols(a, cols)
    ls = lstsq_batched(C, a)
    return InterpolativeDecomposition(cols, ls.x, _rel_fro(a, C @ ls.x),
                                      ok & ls.ok)


@f32_matmuls()
def cur_batched(a: torch.Tensor, k: int) -> CURDecomposition:
    """Rank-k CUR decomposition: columns by the pivoted Cholesky of AᵀA,
    rows by that of AAᵀ, and the core ``U = C⁺ A R⁺`` from two
    least-squares solves (first ``Y = C⁺A``, then U from Rᵀ Uᵀ = Yᵀ,
    minimum norm)."""
    a = a.to(torch.promote_types(a.dtype, torch.float32))
    cols, okc = _select_columns_gram(a, k)
    at = a.transpose(1, 2)
    rows, okr = _select_columns_gram(at, k)
    C = _gather_cols(a, cols)                             # [B, m, k]
    R = _gather_cols(at, rows).transpose(1, 2)            # [B, k, n]
    ls1 = lstsq_batched(C, a)
    ls2 = lstsq_batched(R.transpose(1, 2), ls1.x.transpose(1, 2))
    U = ls2.x.transpose(1, 2)                             # [B, k, k]
    return CURDecomposition(cols, rows, C, U, R,
                            _rel_fro(a, C @ U @ R),
                            okc & okr & ls1.ok & ls2.ok)
