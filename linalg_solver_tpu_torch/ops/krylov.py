"""Batched Krylov solvers: CG, BiCGSTAB, GMRES(m), MINRES and LSQR
(counterpart of ``linalg_solver_tpu.ops.krylov``).

Every iteration is batched matrix–vector work and vector updates on the
device; each system (lane) carries a ``done`` mask, and a lane that is
done keeps its state (its updates are ``torch.where``-ed out), so a slow
lane does not perturb finished ones.  The reference runs each solver as
one device loop whose condition, ``k < max_iters`` and some lane live, is
read on the device.  Here the iterations run in chunks of ``CHUNK``
(``run_chunks``): every iteration of a chunk is gated as a whole by that
condition, a device flag, so an iteration past the stop leaves the state
exactly as it was, and the host reads one scalar a chunk to decide
whether to start the next.  ``iters`` is counted on the device as the
iterations in which some lane was live, the reference's ``k``.

Each solver has a matrix-free entry point (``cg_matvec``, …) taking a
batched ``matvec(v [B, n]) -> [B, n]`` (and an optional ``precond``) and
a dense one (``cg_batched``, …) on ``a [B, n, n]``, whose products run in
true float32 (no TF32: the reference's ``Precision.HIGHEST``).  All return
per-lane ``converged`` flags and the final true relative residuals.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils.precision import f32_matmuls

MatVec = Callable[[torch.Tensor], torch.Tensor]

#: iterations a solver runs between two host reads of its stop flag
CHUNK = 16

#: restarts GMRES runs between two host reads (a restart is m products)
GMRES_CHUNK = 1

#: host reads since the count was last set to 0: of the stop flag here
#: and in ``ops.lobpcg`` (each chunk's end reads one scalar), and of the
#: restart decisions in ``ops.arnoldi`` (one copy a restart)
HOST_READS = 0


class KrylovResult(NamedTuple):
    x: torch.Tensor          # [B, n] solution iterate
    converged: torch.Tensor  # [B] final true residual ≤ 4·tol
    iters: torch.Tensor      # [] int32: iterations executed (some lane live)
    resnorm: torch.Tensor    # [B] final ‖b − Ax‖ / ‖b‖


def run_chunks(
    body: Callable[[Tuple[torch.Tensor, ...]], Tuple[torch.Tensor, ...]],
    state: Tuple[torch.Tensor, ...],
    live: Callable[[Tuple[torch.Tensor, ...]], torch.Tensor],
    max_iters: int,
    chunk: int = CHUNK,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """``state = body(state)`` while ``live(state)`` (a 0-d bool tensor)
    and fewer than ``max_iters`` iterations ran: the reference's
    ``lax.while_loop``.  The iterations run ``chunk`` at a time, each
    gated as a whole by ``live`` (``torch.where(live, new, old)`` on every
    element of the state), and the host reads ``live`` once a chunk.
    Returns the state and the iterations in which ``live`` held, a 0-d
    int32 tensor on the state's device."""
    global HOST_READS
    k = torch.zeros((), dtype=torch.int32, device=state[0].device)
    ran = 0
    while ran < max_iters:
        for _ in range(min(chunk, max_iters - ran)):
            go = live(state)
            new = body(state)
            state = tuple(torch.where(go, n, o) for n, o in zip(new, state))
            k = k + go.to(torch.int32)
        ran += chunk
        if ran >= max_iters:
            break
        HOST_READS += 1
        if not bool(live(state)):
            break
    return state, k


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum(dim=-1)


def _mv_dense(a: torch.Tensor) -> MatVec:
    def matvec(v):
        with f32_matmuls():
            return (a @ v[..., None])[..., 0]
    return matvec


def _identity(v):
    return v


def _jacobi_precond(a: torch.Tensor) -> MatVec:
    tiny = torch.finfo(a.dtype).tiny
    dinv = 1.0 / torch.clamp(torch.diagonal(a, dim1=1, dim2=2).abs(),
                             min=tiny)
    return lambda v: dinv * v


def _nrm(x: torch.Tensor) -> torch.Tensor:
    """Overflow/underflow-safe 2-norm along the last axis (scaled by the
    largest magnitude first: f32 squares of ~1e-20 entries flush to
    zero)."""
    m = x.abs().amax(dim=-1, keepdim=True)
    ms = torch.clamp(m, min=torch.finfo(x.dtype).tiny)
    return m[..., 0] * torch.sqrt(((x / ms) ** 2).sum(dim=-1))


def _prep_b(b: torch.Tensor, tol: Optional[float]):
    """The RHS scaled to unit max-norm per lane (the solvers are exactly
    scale-equivariant in b, so this only keeps the inner products in
    range), its norm, the tolerance (default 100 ulp) and the scale to
    undo on x."""
    dtype = torch.promote_types(b.dtype, torch.float32)
    b = b.to(dtype)
    bscale = b.abs().amax(dim=-1, keepdim=True)
    bscale = torch.where(bscale > 0, bscale, torch.ones_like(bscale))
    b = b / bscale
    bnorm = torch.clamp(_nrm(b), min=torch.finfo(dtype).tiny)
    if tol is None:
        tol = 100.0 * torch.finfo(dtype).eps
    return b, bnorm, float(torch.tensor(tol, dtype=dtype)), bscale


def _not_all(done_index: int):
    """``live`` of ``run_chunks`` for a state whose element
    ``done_index`` is the lanes' done mask."""
    return lambda st: ~st[done_index].all()


def _zero(b: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=b.dtype, device=b.device)


# --- cores (matvec-based) ----------------------------------------------


def cg_matvec(
    matvec: MatVec,
    b: torch.Tensor,
    tol: Optional[float] = None,
    max_iters: int = 0,
    precond: Optional[MatVec] = None,
) -> KrylovResult:
    """Conjugate gradients on SPD operators given a batched ``matvec``
    (and an optional SPD ``precond``).  ``max_iters=0`` picks ``2n``."""
    b, bnorm, tol, bscale = _prep_b(b, tol)
    n = b.shape[1]
    max_iters = max_iters or 2 * n
    M = precond or _identity
    zero = _zero(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    r0 = b
    z0 = M(r0)
    st0 = (torch.zeros_like(b), r0, z0, z0, _dot(r0, z0),
           _nrm(r0) / bnorm <= tol)

    def body(st):
        x, r, z, p, rz, done = st
        ap = matvec(p)
        pap = _dot(p, ap)
        alpha = rz / torch.where(pap != 0, pap, one)
        alpha = torch.where(done | (pap == 0), zero, alpha)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, one)
        beta = torch.where(done | (rz == 0), zero, beta)
        p = torch.where(done[:, None], p, z + beta[:, None] * p)
        done = done | (_nrm(r) / bnorm <= tol)
        return x, r, z, p, rz_new, done

    st, k = run_chunks(body, st0, _not_all(5), max_iters)
    x = st[0]
    res = _nrm(b - matvec(x)) / bnorm
    return KrylovResult(x * bscale, res <= 4.0 * tol, k, res)


def bicgstab_matvec(
    matvec: MatVec,
    b: torch.Tensor,
    tol: Optional[float] = None,
    max_iters: int = 0,
    precond: Optional[MatVec] = None,
) -> KrylovResult:
    """BiCGSTAB on general square operators given a batched ``matvec``
    (two matvecs a step; ``precond`` applies on the right).
    ``max_iters=0`` picks ``4n``.  Breakdown lanes (ρ ≈ 0) freeze and
    report ``converged=False`` unless already at tol."""
    b, bnorm, tol, bscale = _prep_b(b, tol)
    B, n = b.shape
    max_iters = max_iters or 4 * n
    M = precond or _identity
    one = torch.ones((), dtype=b.dtype, device=b.device)
    eps = torch.finfo(b.dtype).eps

    rhat = b
    ones = torch.ones(B, dtype=b.dtype, device=b.device)
    st0 = (torch.zeros_like(b), b, torch.zeros_like(b), torch.zeros_like(b),
           ones, ones, ones, _nrm(b) / bnorm <= tol)

    def body(st):
        x, r, p, v, rho, alpha, omega, done = st
        rho_new = _dot(rhat, r)
        broke = rho_new.abs() <= (eps * _nrm(rhat)) * (eps * _nrm(r))
        beta = (rho_new / torch.where(rho == 0, one, rho)) * (
            alpha / torch.where(omega == 0, one, omega))
        p = r + beta[:, None] * (p - omega[:, None] * v)
        phat = M(p)
        v = matvec(phat)
        rv = _dot(rhat, v)
        alpha = rho_new / torch.where(rv == 0, one, rv)
        s = r - alpha[:, None] * v
        shat = M(s)
        t = matvec(shat)
        tt = _dot(t, t)
        omega = _dot(t, s) / torch.where(tt == 0, one, tt)
        x_new = x + alpha[:, None] * phat + omega[:, None] * shat
        r_new = s - omega[:, None] * t
        frozen = done | broke
        x = torch.where(frozen[:, None], x, x_new)
        r = torch.where(frozen[:, None], r, r_new)
        done = done | (~broke & (_nrm(r) / bnorm <= tol)) | broke
        return x, r, p, v, rho_new, alpha, omega, done

    st, k = run_chunks(body, st0, _not_all(7), max_iters)
    x = st[0]
    res = _nrm(b - matvec(x)) / bnorm
    return KrylovResult(x * bscale, res <= 4.0 * tol, k, res)


def gmres_matvec(
    matvec: MatVec,
    b: torch.Tensor,
    tol: Optional[float] = None,
    restart: int = 32,
    max_restarts: int = 8,
    precond: Optional[MatVec] = None,
) -> KrylovResult:
    """Restarted GMRES(m) on general square operators given a batched
    ``matvec`` (``precond`` applies on the right): Arnoldi with modified
    Gram–Schmidt over a fixed ``restart``-wide basis ``V [B, m+1, n]``
    (the reference's inner ``fori_loop``, a Python loop of m steps here),
    then the small least-squares problem per lane by its ridged normal
    equations.  Converged lanes freeze across restarts; ``iters`` is the
    restarts run times m, as in the reference."""
    b, bnorm, tol, bscale = _prep_b(b, tol)
    B, n = b.shape
    m = min(restart, n)
    tiny = torch.finfo(b.dtype).tiny
    M = precond or _identity
    slots = torch.arange(m + 1, device=b.device)
    eye_m = torch.eye(m, dtype=b.dtype, device=b.device)

    def one_cycle(x):
        r = b - matvec(x)
        beta = _nrm(r)
        V = torch.zeros(B, m + 1, n, dtype=b.dtype, device=b.device)
        V[:, 0] = r / torch.clamp(beta, min=tiny)[:, None]
        H = torch.zeros(B, m + 1, m, dtype=b.dtype, device=b.device)
        with f32_matmuls():
            for j in range(m):
                w = matvec(M(V[:, j]))
                # MGS against all m+1 slots: slots past j are still zero
                hcol = (V @ w[:, :, None])[:, :, 0]
                hcol = torch.where(slots[None, :] <= j, hcol,
                                   torch.zeros_like(hcol))
                w = w - (hcol[:, None, :] @ V)[:, 0]
                hnorm = _nrm(w)
                hcol[:, j + 1] = hnorm
                H[:, :, j] = hcol
                V[:, j + 1] = w / torch.clamp(hnorm, min=tiny)[:, None]
            g = torch.zeros(B, m + 1, dtype=b.dtype, device=b.device)
            g[:, 0] = beta
            HtH = H.transpose(1, 2) @ H
            Htg = (H.transpose(1, 2) @ g[:, :, None])[:, :, 0]
            ridge = 1e-7 * torch.diagonal(HtH, dim1=1, dim2=2).sum(dim=1)
            y = torch.linalg.solve_ex(HtH + ridge[:, None, None] * eye_m,
                                      Htg[:, :, None])[0][:, :, 0]
            dx = M((y[:, None, :] @ V[:, :m])[:, 0])
        return x + dx

    def body(st):
        x, done = st
        x = torch.where(done[:, None], x, one_cycle(x))
        return x, done | (_nrm(b - matvec(x)) / bnorm <= tol)

    st0 = (torch.zeros_like(b), _nrm(b) / bnorm <= tol)
    st, k = run_chunks(body, st0, _not_all(1), max_restarts,
                       chunk=GMRES_CHUNK)
    x = st[0]
    res = _nrm(b - matvec(x)) / bnorm
    return KrylovResult(x * bscale, res <= 4.0 * tol, k * m, res)


def minres_matvec(
    matvec: MatVec,
    b: torch.Tensor,
    tol: Optional[float] = None,
    max_iters: int = 0,
) -> KrylovResult:
    """MINRES on symmetric (possibly indefinite) operators: the Lanczos
    three-term recurrence and two trailing Givens rotations
    (Paige–Saunders), one matvec a step; the rotated residual ``|η|``
    tracks ‖b − Ax‖.  ``max_iters=0`` picks ``2n``."""
    b, bnorm, tol, bscale = _prep_b(b, tol)
    B, n = b.shape
    max_iters = max_iters or 2 * n
    tiny = torch.finfo(b.dtype).tiny
    eps = torch.finfo(b.dtype).eps

    beta1 = _nrm(b)
    v0 = b / torch.clamp(beta1, min=tiny)[:, None]
    ones = torch.ones(B, dtype=b.dtype, device=b.device)
    zeros = torch.zeros(B, dtype=b.dtype, device=b.device)
    st0 = (torch.zeros_like(b), torch.zeros_like(b), v0, beta1, beta1,
           ones, ones, zeros, zeros, torch.zeros_like(b),
           torch.zeros_like(b), beta1 / bnorm <= tol)

    def body(st):
        (x, v_old, v, beta, eta, g0, g1, s0, s1, w0, w1, done) = st
        av = matvec(v)
        alpha = _dot(v, av)
        p = av - alpha[:, None] * v - beta[:, None] * v_old
        beta_new = _nrm(p)
        v_new = p / torch.clamp(beta_new, min=tiny)[:, None]
        delta = g1 * alpha - g0 * s1 * beta
        rho1 = torch.sqrt(delta * delta + beta_new * beta_new)
        rho2 = s1 * alpha + g0 * g1 * beta
        rho3 = s0 * beta
        rho1s = torch.clamp(rho1, min=tiny)
        g_new = delta / rho1s
        s_new = beta_new / rho1s
        w_new = (v - rho3[:, None] * w0 - rho2[:, None] * w1) / rho1s[:, None]
        x_new = x + (g_new * eta)[:, None] * w_new
        eta_new = -s_new * eta
        # a degenerate rotation (the Krylov space is invariant): freeze
        # the lane before applying it
        broke = rho1 <= (alpha.abs() + beta + beta_new) * eps
        upd = ~(done | broke)
        sel = upd[:, None]
        x = torch.where(sel, x_new, x)
        eta = torch.where(upd, eta_new, eta)
        done = done | broke | (eta.abs() / bnorm <= tol)
        return (x, torch.where(sel, v, v_old), torch.where(sel, v_new, v),
                torch.where(upd, beta_new, beta), eta,
                torch.where(upd, g1, g0), torch.where(upd, g_new, g1),
                torch.where(upd, s1, s0), torch.where(upd, s_new, s1),
                torch.where(sel, w1, w0), torch.where(sel, w_new, w1), done)

    st, k = run_chunks(body, st0, _not_all(11), max_iters)
    x = st[0]
    res = _nrm(b - matvec(x)) / bnorm
    return KrylovResult(x * bscale, res <= 4.0 * tol, k, res)


class LSQRResult(NamedTuple):
    x: torch.Tensor          # [B, n] least-squares iterate
    converged: torch.Tensor  # [B] ‖r‖/‖b‖ ≤ 4·tol or ‖Aᵀr‖/(‖A‖‖r‖) ≤ 4·tol
    iters: torch.Tensor      # [] int32
    resnorm: torch.Tensor    # [B] final ‖b − Ax‖ / ‖b‖
    atresnorm: torch.Tensor  # [B] final ‖Aᵀr‖ / (‖A‖·‖r‖), damped operator


def lsqr_matvec(
    matvec: MatVec,
    rmatvec: MatVec,
    b: torch.Tensor,
    n: int,
    tol: Optional[float] = None,
    max_iters: int = 0,
    damp: float = 0.0,
) -> LSQRResult:
    """LSQR (Paige–Saunders) on a rectangular operator: minimizes
    ``‖Ax − b‖² + damp²‖x‖²`` given ``matvec: [B, n] → [B, m]`` and its
    adjoint ``rmatvec``, by Golub–Kahan bidiagonalization with one
    rotation a step.  ``max_iters=0`` picks ``2n``."""
    b, bnorm, tol, bscale = _prep_b(b, tol)
    B, _ = b.shape
    max_iters = max_iters or 2 * n
    tiny = torch.finfo(b.dtype).tiny
    dampv = torch.tensor(damp, dtype=b.dtype, device=b.device)

    beta1 = _nrm(b)
    u0 = b / torch.clamp(beta1, min=tiny)[:, None]
    atu = rmatvec(u0)
    alpha1 = _nrm(atu)
    v0 = atu / torch.clamp(alpha1, min=tiny)[:, None]
    st0 = (torch.zeros(B, n, dtype=b.dtype, device=b.device), u0, v0, v0,
           alpha1, beta1, alpha1, torch.sqrt(alpha1 * alpha1),
           alpha1 * beta1, beta1 / bnorm <= tol)

    def body(st):
        (x, u, v, w, alpha, phibar, rhobar, anorm, arnorm, done) = st
        u_new = matvec(v) - alpha[:, None] * u
        beta = _nrm(u_new)
        u_new = u_new / torch.clamp(beta, min=tiny)[:, None]
        v_new = rmatvec(u_new) - beta[:, None] * v
        alpha_new = _nrm(v_new)
        v_new = v_new / torch.clamp(alpha_new, min=tiny)[:, None]
        # the damping row rotated into rhobar
        rhobar1 = torch.sqrt(rhobar * rhobar + dampv * dampv)
        c1 = rhobar / torch.clamp(rhobar1, min=tiny)
        phibar1 = c1 * phibar
        # the trailing Givens rotation of the lower-bidiagonal column
        rho = torch.sqrt(rhobar1 * rhobar1 + beta * beta)
        rhos = torch.clamp(rho, min=tiny)
        c = rhobar1 / rhos
        s = beta / rhos
        theta = s * alpha_new
        rhobar_new = -c * alpha_new
        phi = c * phibar1
        phibar_new = s * phibar1
        x_new = x + (phi / rhos)[:, None] * w
        w_new = v_new - (theta / rhos)[:, None] * w
        anorm_new = torch.sqrt(anorm * anorm + alpha_new * alpha_new
                               + beta * beta + dampv * dampv)
        # phibar carries a sign: the tests need magnitudes
        arnorm_new = (phibar_new * alpha_new * c).abs()
        upd = ~done
        sel = upd[:, None]
        x = torch.where(sel, x_new, x)
        phibar = torch.where(upd, phibar_new, phibar)
        arnorm = torch.where(upd, arnorm_new, arnorm)
        done = done | (phibar.abs() / bnorm <= tol) | (
            arnorm <= tol * anorm_new * torch.clamp(phibar.abs(), min=tiny))
        return (x, torch.where(sel, u_new, u), torch.where(sel, v_new, v),
                torch.where(sel, w_new, w), torch.where(upd, alpha_new, alpha),
                phibar, torch.where(upd, rhobar_new, rhobar),
                torch.where(upd, anorm_new, anorm), arnorm, done)

    st, k = run_chunks(body, st0, _not_all(9), max_iters)
    x, anorm = st[0], st[7]
    r = b - matvec(x)
    resnorm = _nrm(r) / bnorm
    # ‖Aᵀr − damp²x‖ / (‖A‖·‖r̄‖), ‖r̄‖² = ‖r‖² + damp²‖x‖²
    atr = rmatvec(r) - (dampv * dampv) * x
    rbar = torch.sqrt(_nrm(r) ** 2 + (dampv * _nrm(x)) ** 2)
    atres = _nrm(atr) / torch.clamp(
        torch.clamp(anorm, min=tiny) * torch.clamp(rbar, min=tiny), min=tiny)
    conv = (resnorm <= 4.0 * tol) | (atres <= 4.0 * tol)
    return LSQRResult(x * bscale, conv, k, resnorm, atres)


# --- dense entry points --------------------------------------------------


def _as_float(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.promote_types(a.dtype, torch.float32))


@f32_matmuls()
def cg_batched(a: torch.Tensor, b: torch.Tensor, tol: Optional[float] = None,
               max_iters: int = 0, jacobi: bool = False) -> KrylovResult:
    """Conjugate gradients on batched SPD systems ``a [B, n, n] x = b``.
    ``jacobi=True`` preconditions with ``diag(A)⁻¹``; ``max_iters=0``
    picks ``2n``."""
    a = _as_float(a)
    return cg_matvec(_mv_dense(a), b, tol=tol, max_iters=max_iters,
                     precond=_jacobi_precond(a) if jacobi else None)


@f32_matmuls()
def bicgstab_batched(a: torch.Tensor, b: torch.Tensor,
                     tol: Optional[float] = None, max_iters: int = 0,
                     jacobi: bool = False) -> KrylovResult:
    """BiCGSTAB on batched general square systems (two products a step);
    ``max_iters=0`` picks ``4n``."""
    a = _as_float(a)
    return bicgstab_matvec(_mv_dense(a), b, tol=tol, max_iters=max_iters,
                           precond=_jacobi_precond(a) if jacobi else None)


@f32_matmuls()
def gmres_batched(a: torch.Tensor, b: torch.Tensor,
                  tol: Optional[float] = None, restart: int = 32,
                  max_restarts: int = 8, jacobi: bool = False
                  ) -> KrylovResult:
    """Restarted GMRES(m) on batched general square systems (see
    ``gmres_matvec``)."""
    a = _as_float(a)
    return gmres_matvec(_mv_dense(a), b, tol=tol, restart=restart,
                        max_restarts=max_restarts,
                        precond=_jacobi_precond(a) if jacobi else None)


@f32_matmuls()
def minres_batched(a: torch.Tensor, b: torch.Tensor,
                   tol: Optional[float] = None, max_iters: int = 0,
                   jacobi: bool = False) -> KrylovResult:
    """MINRES on batched symmetric (possibly indefinite) systems; the
    input is symmetrized first.  ``jacobi=True`` scales symmetrically,
    ``D^{-1/2} A D^{-1/2}`` with ``D = |diag(A)|``, and reports the true
    residual of the original system."""
    a = _as_float(a)
    a = 0.5 * (a + a.transpose(1, 2))
    b = b.to(a.dtype)
    if not jacobi:
        return minres_matvec(_mv_dense(a), b, tol=tol, max_iters=max_iters)
    tiny = torch.finfo(a.dtype).tiny
    d = torch.sqrt(torch.clamp(torch.diagonal(a, dim1=1, dim2=2).abs(),
                               min=tiny))
    a_s = a / (d[:, :, None] * d[:, None, :])
    r = minres_matvec(_mv_dense(a_s), b / d, tol=tol, max_iters=max_iters)
    x = r.x / d
    eff_tol = 100.0 * torch.finfo(a.dtype).eps if tol is None else tol
    bnorm = torch.clamp(_nrm(b), min=tiny)
    resnorm = _nrm(b - _mv_dense(a)(x)) / bnorm
    return KrylovResult(x, resnorm <= 4.0 * float(
        torch.tensor(eff_tol, dtype=a.dtype)), r.iters, resnorm)


@f32_matmuls()
def lsqr_batched(a: torch.Tensor, b: torch.Tensor,
                 tol: Optional[float] = None, max_iters: int = 0,
                 damp: float = 0.0) -> LSQRResult:
    """LSQR on batched rectangular systems ``[B, m, n]``: minimizes
    ``‖Ax − b‖² + damp²‖x‖²`` without forming ``AᵀA``; for m < n with
    ``damp=0`` it reaches the minimum-norm solution."""
    a = _as_float(a)
    at = a.transpose(1, 2)

    def rmv(u):
        with f32_matmuls():
            return (at @ u[..., None])[..., 0]

    return lsqr_matvec(_mv_dense(a), rmv, b, a.shape[2], tol=tol,
                       max_iters=max_iters, damp=damp)


def reset_host_reads() -> None:
    """Set ``HOST_READS`` to 0."""
    global HOST_READS
    HOST_READS = 0

