"""Batched matrix functions (counterpart of
``linalg_solver_tpu.ops.funm``): expm, sqrtm, logm, powm (general and
SPD), the trigonometric and hyperbolic functions, ``funm`` on the
eigendecomposition, expm's Fréchet derivative and condition number, and
the action ``expm(tA) v``.

- ``expm_batched``: scaling and squaring with the [13/13] Padé
  approximant (Higham 2005): batched products and one batched solve,
  then a per-lane number of squarings (lanes with squarings left square,
  the others keep their value).  Differentiable: the adjoint of
  ``E ↦ L(A, E)`` is ``G ↦ L(Aᵀ, G)`` (Higham 2008, Thm. 10.17), one
  ``expm_frechet_batched`` call.
- ``sqrtm_batched``: coupled Denman–Beavers with determinantal scaling
  (two inverses a step); ``logm_batched``: inverse scaling and squaring
  (square roots until ``‖X − I‖₁ ≤ θ``, then a [7/7] Gauss–Legendre
  Padé of ``log(I + E)``); ``powm_batched = expm(p·logm)``.
- ``cosm/sinm/tanm``: one 2n expm of ``[[0, A], [−A, 0]]`` gives cos and
  sin; ``coshm/sinhm/tanhm`` from one expm of the stacked ``[A; −A]``.
- ``funm_batched``: ``V f(Λ) V⁻¹`` on ``ops.schur.eig_batched``, in
  native complex arithmetic, with the reconstruction residual; ``V⁻¹``
  through the real 2n embedding and ``ops.dispatch.inverse_batched``, as
  the reference's ``complexlin.inverse_complex_batched`` inverts it.
- ``*_spd_batched``: ``V f(Λ) Vᵀ`` on ``ops.symmetric.eigh_batched``.

The reference's early-stopping ``while_loop``s stop here on a host read
a step (the squaring count on one host read a call); a done lane is
frozen, so the result is the early stop's.  ``jnp.linalg.inv`` and
``solve`` are the library's ``inv_ex``/``solve_ex`` with NaN where the
LU meets a zero pivot, as in the reference.  Every product runs in full
float32 (``f32_matmuls``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import draws
from ..utils.precision import f32_matmuls
from .schur import _f32
from .sign import inv_or_nan
from .sylvester import solve_or_nan

#: [13/13] Padé coefficients for exp (Higham 2005)
_PADE13 = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0,
    670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
    960960.0, 16380.0, 182.0, 1.0,
)
#: θ₁₃: below this 1-norm the unscaled [13/13] approximant is at double
#: precision
_THETA13 = 4.25
#: the squaring count's cap (f32 amplifies roundoff to O(1) past ~24)
_MAX_SQUARINGS = 64


@f32_matmuls()
def _expm_impl(a: torch.Tensor) -> torch.Tensor:
    B, n, _ = a.shape
    a = _f32(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
    # per-lane squaring count s: ‖A/2^s‖₁ ≤ θ₁₃
    norm1 = a.abs().sum(dim=1).amax(dim=1)
    s = torch.nan_to_num(torch.ceil(torch.log2(torch.clamp(
        norm1 / _THETA13, min=1.0))), nan=0.0)
    s = torch.clamp(s.to(torch.int32), max=_MAX_SQUARINGS)
    x = a * torch.exp2(-s.to(a.dtype))[:, None, None]
    b = _PADE13
    x2 = x @ x
    x4 = x2 @ x2
    x6 = x2 @ x4
    # U = X(b13·X6 + b11·X4 + b9·X2)·X6 + X(b7·X6 + b5·X4 + b3·X2 + b1·I)
    w1 = b[13] * x6 + b[11] * x4 + b[9] * x2
    w2 = b[7] * x6 + b[5] * x4 + b[3] * x2 + b[1] * eye
    U = x @ (x6 @ w1 + w2)
    # V = (b12·X6 + b10·X4 + b8·X2)·X6 + b6·X6 + b4·X4 + b2·X2 + b0·I
    z1 = b[12] * x6 + b[10] * x4 + b[8] * x2
    V = x6 @ z1 + b[6] * x6 + b[4] * x4 + b[2] * x2 + b[0] * eye
    r = solve_or_nan(V - U, V + U)
    # undo the scaling: lanes with squarings left square
    for k in range(int(s.max()) if B else 0):
        r = torch.where((k < s)[:, None, None], r @ r, r)
    return r


class _Expm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return _expm_impl(a)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return expm_frechet_batched(a.transpose(1, 2), g).L.to(a.dtype)


def expm_batched(a: torch.Tensor) -> torch.Tensor:
    """Matrix exponential of a batched ``[B, n, n]`` real matrix.
    Differentiable through the Fréchet derivative (module docstring)."""
    return _Expm.apply(a)


class SqrtmResult(NamedTuple):
    """``Y ≈ A^{1/2}`` (principal), ``Yinv ≈ A^{-1/2}``, per-lane
    ``converged``, and the Newton steps executed."""

    Y: torch.Tensor
    Yinv: torch.Tensor
    converged: torch.Tensor
    iters: torch.Tensor


class LogmResult(NamedTuple):
    """``L ≈ log A`` (principal), per-lane ``converged``, and each lane's
    number of inverse-scaling square roots ``roots``."""

    L: torch.Tensor
    converged: torch.Tensor
    roots: torch.Tensor


@f32_matmuls()
def _db_sqrt(a: torch.Tensor, max_iters: int):
    """Coupled Denman–Beavers iteration with determinantal scaling:
    ``Y ← (μY + (μZ)⁻¹)/2``, ``Z ← (μZ + (μY)⁻¹)/2``,
    ``μ = |det Y · det Z|^{-1/(2n)}``; ``Y → A^{1/2}``, ``Z → A^{-1/2}``.
    A converged lane freezes; the host reads the done flags once a step."""
    B, n, _ = a.shape
    eps = torch.finfo(a.dtype).eps
    anorm = torch.clamp(a.abs().amax(dim=(1, 2)),
                        min=torch.finfo(a.dtype).tiny)

    def relchange(Y_new, Y):
        num = (Y_new - Y).abs().amax(dim=(1, 2))
        return num / torch.clamp(Y_new.abs().amax(dim=(1, 2)), min=1e-30)

    Y = a
    Z = torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
    done = torch.zeros(B, dtype=torch.bool, device=a.device)
    k = 0
    while k < max_iters and not bool(done.all()):
        _, ly = torch.linalg.slogdet(Y)
        _, lz = torch.linalg.slogdet(Z)
        mu = torch.exp(-(ly + lz) / (2.0 * n))
        mu = torch.where(torch.isfinite(mu) & (mu > 0), mu, 1.0)[:, None, None]
        Yinv, Zinv = inv_or_nan(mu * Y), inv_or_nan(mu * Z)
        Y_new = 0.5 * (mu * Y + Zinv)
        Z_new = 0.5 * (mu * Z + Yinv)
        done_new = done | (relchange(Y_new, Y) <= 100.0 * eps)
        Y = torch.where(done[:, None, None], Y, Y_new)
        Z = torch.where(done[:, None, None], Z, Z_new)
        done = done_new
        k += 1
    resid = (Y @ Y - a).abs().amax(dim=(1, 2)) / anorm
    return Y, Z, resid <= 1e3 * n * eps, k


def sqrtm_batched(a: torch.Tensor, max_iters: int = 50) -> SqrtmResult:
    """Principal square root of a general batched ``[B, n, n]`` real
    matrix with no eigenvalues on the closed negative real axis; the
    coupled iteration also returns ``A^{-1/2}``.  SPD callers should
    prefer ``sqrtm_spd_batched``."""
    Y, Z, conv, k = _db_sqrt(_f32(a), max_iters)
    return SqrtmResult(Y, Z, conv, torch.tensor(k, dtype=torch.int32,
                                                device=a.device))


#: [7/7] Padé of log(1+x) in Gauss–Legendre partial-fraction form:
#: log(I+E) ≈ Σ wᵢ E (I + tᵢ E)⁻¹, (tᵢ, wᵢ) the 7-point rule on [0, 1];
#: θ = 0.25 keeps its error below double-precision eps (Higham 2008,
#: Table 11.1)
_LOGM_THETA = 0.25
_LOGM_NODES, _LOGM_WEIGHTS = (
    lambda xw: (((xw[0] + 1.0) / 2.0).tolist(), (xw[1] / 2.0).tolist())
)(np.polynomial.legendre.leggauss(7))


@f32_matmuls()
def logm_batched(a: torch.Tensor, max_roots: int = 24,
                 max_iters: int = 50) -> LogmResult:
    """Principal logarithm of a general batched real matrix with no
    eigenvalues on the closed negative real axis: Denman–Beavers square
    roots a lane until ``‖A^{1/2^s} − I‖₁ ≤ θ``, a [7/7] Gauss–Legendre
    Padé (7 batched inverses), then ``L = 2^s · log(A^{1/2^s})``.  SPD
    callers should prefer ``logm_spd_batched``."""
    B, n, _ = a.shape
    X = _f32(a)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)

    def dist1(X):
        return (X - eye).abs().sum(dim=1).amax(dim=1)

    s = torch.zeros(B, dtype=torch.int32, device=X.device)
    ok = torch.ones(B, dtype=torch.bool, device=X.device)
    k = 0
    while k < max_roots:
        active = ok & (dist1(X) > _LOGM_THETA)
        if not bool(active.any()):
            break
        Y, _, conv, _ = _db_sqrt(X, max_iters)
        X = torch.where(active[:, None, None], Y, X)
        ok = ok & (conv | ~active)
        s = s + active.to(torch.int32)
        k += 1
    ok = ok & (dist1(X) <= _LOGM_THETA)
    E = X - eye
    L = torch.zeros_like(E)
    for t, w in zip(_LOGM_NODES, _LOGM_WEIGHTS):
        L = L + w * (E @ inv_or_nan(eye + t * E))
    L = L * torch.exp2(s.to(X.dtype))[:, None, None]
    return LogmResult(L, ok, s)


def powm_batched(a: torch.Tensor, p: float, max_roots: int = 24,
                 max_iters: int = 50):
    """General real matrix power ``A^p = expm(p · log A)`` (principal
    branch, the domain of ``logm_batched``).  Returns ``(A^p,
    converged)``.  SPD callers should prefer ``powm_spd_batched``."""
    res = logm_batched(a, max_roots=max_roots, max_iters=max_iters)
    return expm_batched(p * res.L), res.converged


@f32_matmuls()
def _spd_spectral(a: torch.Tensor, f, floor: float) -> torch.Tensor:
    from .symmetric import eigh_batched

    res = eigh_batched(a)
    fw = f(torch.clamp(res.w, min=floor))
    return (res.V * fw[:, None, :]) @ res.V.transpose(1, 2)


def sqrtm_spd_batched(a: torch.Tensor) -> torch.Tensor:
    """Principal square root of symmetric PSD batches (eigh spectral form;
    negative roundoff eigenvalues clamped to 0)."""
    return _spd_spectral(a, torch.sqrt, 0.0)


def logm_spd_batched(a: torch.Tensor) -> torch.Tensor:
    """Matrix logarithm of symmetric positive definite batches."""
    return _spd_spectral(a, torch.log, torch.finfo(torch.float32).tiny)


def powm_spd_batched(a: torch.Tensor, p: float) -> torch.Tensor:
    """Real matrix power ``A^p`` of symmetric PSD batches (e.g. the inverse
    square root p = −1/2 used for whitening)."""
    floor = 0.0 if p >= 0 else torch.finfo(torch.float32).tiny
    return _spd_spectral(a, lambda w: torch.pow(w, p), floor)


def cosm_sinm_batched(a: torch.Tensor):
    """Matrix cosine and sine from one exponential of the skew embedding
    ``[[0, A], [−A, 0]]`` (= ``A ⊗ [[0, 1], [−1, 0]]``, so the blocks
    commute): ``expm = [[cos A, sin A], [−sin A, cos A]]``.  Returns
    ``(cos A, sin A)``."""
    n = a.shape[-1]
    a = _f32(a)
    z = torch.zeros_like(a)
    E = expm_batched(torch.cat([torch.cat([z, a], dim=2),
                                torch.cat([-a, z], dim=2)], dim=1))
    return E[:, :n, :n], E[:, :n, n:]


def cosm_batched(a: torch.Tensor) -> torch.Tensor:
    """Matrix cosine (see ``cosm_sinm_batched``)."""
    return cosm_sinm_batched(a)[0]


def sinm_batched(a: torch.Tensor) -> torch.Tensor:
    """Matrix sine (see ``cosm_sinm_batched``)."""
    return cosm_sinm_batched(a)[1]


def tanm_batched(a: torch.Tensor) -> torch.Tensor:
    """Matrix tangent ``cos(A)⁻¹ sin(A)`` (NaN where cos A is singular)."""
    c, s = cosm_sinm_batched(a)
    return solve_or_nan(c, s)


def coshm_sinhm_batched(a: torch.Tensor):
    """Matrix cosh and sinh, ``(expm(A) ± expm(−A))/2``, the two
    exponentials in one call on the stacked ``[2B]`` batch.  Returns
    ``(cosh A, sinh A)``."""
    a = _f32(a)
    B = a.shape[0]
    E = expm_batched(torch.cat([a, -a], dim=0))
    ep, en = E[:B], E[B:]
    return 0.5 * (ep + en), 0.5 * (ep - en)


def coshm_batched(a: torch.Tensor) -> torch.Tensor:
    """Matrix hyperbolic cosine (see ``coshm_sinhm_batched``)."""
    return coshm_sinhm_batched(a)[0]


def sinhm_batched(a: torch.Tensor) -> torch.Tensor:
    """Matrix hyperbolic sine (see ``coshm_sinhm_batched``)."""
    return coshm_sinhm_batched(a)[1]


def tanhm_batched(a: torch.Tensor) -> torch.Tensor:
    """Matrix hyperbolic tangent ``cosh(A)⁻¹ sinh(A)``."""
    c, s = coshm_sinhm_batched(a)
    return solve_or_nan(c, s)


class FunmResult(NamedTuple):
    """General matrix function ``f(A) = V f(Λ) V⁻¹``: ``F`` its real part
    (exact for a real-analytic ``f``), ``imag_max`` each lane's max |Im|
    (roundoff, or a non-conjugate-symmetric ``f``), ``resid`` the
    relative reconstruction error ``‖V Λ V⁻¹ − A‖_max / ‖A‖_max`` (it
    grows with κ(V)), and ``ok`` = converged, every column valid and
    ``resid`` at the f32 floor."""

    F: torch.Tensor         # [B, n, n]
    imag_max: torch.Tensor  # [B]
    resid: torch.Tensor     # [B]
    ok: torch.Tensor        # [B]


@f32_matmuls()
def funm_batched(a: torch.Tensor, f) -> FunmResult:
    """Apply an analytic scalar function to a batched general real matrix
    through the complex eigendecomposition ``A = V Λ V⁻¹ ⇒ f(A) =
    V f(Λ) V⁻¹``.  ``f`` takes a complex torch tensor ``[B, n]`` of
    eigenvalues and must be analytic on the spectrum; near-defective input
    should use the specialised routines (``resid`` shows it)."""
    from .complexlin import inverse_complex_batched
    from .schur import eig_batched

    a = _f32(a)
    n = a.shape[-1]
    r = eig_batched(a)
    lam = torch.complex(r.real, r.imag)
    V = torch.complex(r.vectors_real, r.vectors_imag)
    fd = torch.as_tensor(f(lam), device=a.device).to(V.dtype)
    # V⁻¹ through the real embedding on dispatch.inverse_batched (at n =
    # 256 the 512 × 512 inverse runs the RBT phase engine's kernels)
    Vinv = torch.complex(*inverse_complex_batched(r.vectors_real,
                                                  r.vectors_imag))
    Fc = (V * fd[:, None, :]) @ Vinv
    # the reconstruction with the same V, V⁻¹: f = identity
    Ac = (V * lam[:, None, :]) @ Vinv
    anorm = torch.clamp(a.abs().amax(dim=(1, 2)), min=1e-30)
    resid = ((Ac.real - a).abs() + Ac.imag.abs()).amax(dim=(1, 2)) / anorm
    eps = torch.finfo(a.dtype).eps
    ok = r.converged & r.valid.all(dim=1) & (resid <= 1e3 * n * eps)
    return FunmResult(Fc.real.contiguous(), Fc.imag.abs().amax(dim=(1, 2)),
                      resid, ok)


class ExpmFrechetResult(NamedTuple):
    """``expm(A)`` and the Fréchet derivative ``L(A, E)``."""

    expm: torch.Tensor  # [B, n, n]
    L: torch.Tensor     # [B, n, n]


def expm_frechet_batched(a: torch.Tensor, e: torch.Tensor
                         ) -> ExpmFrechetResult:
    """Fréchet derivative of the matrix exponential along ``E`` by the
    block-triangular embedding (Higham 2008, eq. (10.40)):
    ``expm([[A, E], [0, A]]) = [[expm A, L(A, E)], [0, expm A]]``, one 2n
    ``expm_batched`` call.  ``E`` is scaled to ``‖A‖``'s size inside the
    embedding (``L`` is linear in ``E``) so that it cannot change the
    lanes' squaring counts."""
    n = a.shape[-1]
    a = _f32(a)
    e = e.to(a.dtype)
    anorm = a.abs().amax(dim=(1, 2))
    enorm = e.abs().amax(dim=(1, 2))
    c = torch.where((enorm > 0) & (anorm > 0),
                    enorm / torch.clamp(anorm, min=1e-30), 1.0)
    c = torch.clamp(c, min=torch.finfo(a.dtype).tiny)
    z = torch.zeros_like(a)
    EM = expm_batched(torch.cat([torch.cat([a, e / c[:, None, None]], dim=2),
                                 torch.cat([z, a], dim=2)], dim=1))
    return ExpmFrechetResult(expm=EM[:, :n, :n],
                             L=EM[:, :n, n:] * c[:, None, None])


def expm_cond_batched(a: torch.Tensor, iters: int = 6, e0=None,
                      generator: Optional[torch.Generator] = None):
    """Relative condition number of the matrix exponential in the
    Frobenius norm, ``κ_exp(A) = ‖L(A)‖_F · ‖A‖_F / ‖expm A‖_F`` (scipy's
    ``expm_cond``), the operator norm by power iteration on
    ``L(Aᵀ, ·) ∘ L(A, ·)``: two block exponentials an iteration.  The
    iteration starts from ``e0 [B, n, n]`` (a tensor or a numpy array,
    e.g. the reference's ``jax.random`` draw), else from a standard normal
    draw on ``generator``.  Returns ``(kappa, opnorm)`` a lane."""
    B, n, _ = a.shape
    a = _f32(a)
    (E,) = draws.start((B, n, n), a.dtype, a.device, e0, generator)

    def fro(x):
        return torch.sqrt((x * x).sum(dim=(1, 2)))

    at = a.transpose(1, 2)
    sig = torch.zeros(B, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        E = E / torch.clamp(fro(E), min=1e-30)[:, None, None]
        W = expm_frechet_batched(a, E).L
        sig = fro(W)    # ‖L(A, E)‖_F with ‖E‖_F = 1: → ‖L(A)‖ from below
        E = expm_frechet_batched(at, W).L
    kappa = sig * fro(a) / torch.clamp(fro(expm_batched(a)), min=1e-30)
    return kappa, sig


class ExpmvResult(NamedTuple):
    """``x ≈ expm(t·A) v``; ``segments`` each lane's scaling count;
    ``ok=False`` where the norm bound asked for more than ``max_segments``
    (the result there is a truncated-time propagation)."""

    x: torch.Tensor         # [B, n]
    segments: torch.Tensor  # [B] int32
    ok: torch.Tensor        # [B] bool


def expm_multiply_matvec(matvec, v: torch.Tensor, norm_bound: torch.Tensor,
                         t: float = 1.0, taylor_m: int = 12,
                         max_segments: int = 4096) -> ExpmvResult:
    """Action ``expm(t·A) v`` without forming ``expm`` (Al-Mohy–Higham
    style scaling and truncated Taylor): ``t`` split into ``s`` segments
    with ``‖t·A‖/s ≤ 1``, each applied by ``taylor_m`` matvecs.
    ``norm_bound [B]`` must bound ``‖A‖`` a lane.  Lanes finish at their
    own ``s`` and freeze; the segment loop runs to the batch's largest
    ``s`` (one host read)."""
    v = _f32(v)
    need = torch.ceil(abs(t) * norm_bound.to(v.dtype)).to(torch.int32)
    s = torch.clamp(need, 1, max_segments)
    ok = need <= max_segments
    h = t / s.to(v.dtype)                 # [B] each lane's segment step

    def taylor(w):
        term, acc = w, w
        for j in range(1, taylor_m + 1):
            term = matvec(term) * (h / j)[:, None]
            acc = acc + term
        return acc

    x = v
    for seg in range(int(s.max()) if s.numel() else 0):
        x = torch.where((seg < s)[:, None], taylor(x), x)
    return ExpmvResult(x=x, segments=s, ok=ok)


@f32_matmuls()
def expm_multiply_batched(a: torch.Tensor, v: torch.Tensor, t: float = 1.0,
                          taylor_m: int = 12, max_segments: int = 4096
                          ) -> ExpmvResult:
    """Dense-matrix form of ``expm_multiply_matvec``: the exact batched
    1-norm as the bound, a batched matrix-vector product as the matvec."""
    a = _f32(a)
    norm1 = a.abs().sum(dim=1).amax(dim=1)

    def matvec(w):
        return (a @ w[:, :, None])[:, :, 0]

    return expm_multiply_matvec(matvec, v, norm1, t=t, taylor_m=taylor_m,
                                max_segments=max_segments)
