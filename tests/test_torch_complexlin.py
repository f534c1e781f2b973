"""The port's complex layer (``linalg_solver_tpu_torch.ops.complexlin``),
its linear half, against the JAX package on the same numpy inputs: the
embedded solve and inverse, the pivoted complex elimination (the plain
version of ``kernels.complex_gauss``) with det and slogdet, Cholesky, QR,
the pseudoinverse and least squares, the dd solve and the basis
completion.  The spectral half is in ``tests/test_torch_complexlin_eig.py``.

Tolerances, relative to the largest entry of the JAX result a lane:
1e-5 where both run the same loop (``backend="loop"``, the elimination,
Cholesky), 1e-4 on ``"auto"`` (the two packages take different routes at
even N < 256, ROADMAP queue 3) and through the SVD-based pseudoinverse;
the dd solve to 1e-10 of ‖x‖ in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import complexlin as jcx
from linalg_solver_tpu_torch import ops as tops
from linalg_solver_tpu_torch.ops import complexlin as tcx
from linalg_solver_tpu_torch.ops.kernels import complex_gauss as cg

B, N = 4, 8


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _c128(x):
    x = np.asarray(x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def _close(got, want, tol):
    want, got = _c128(want), _c128(got)
    assert got.shape == want.shape
    for b in range(want.shape[0]):
        scale = max(np.abs(want[b]).max(), 1e-30)
        assert np.abs(got[b] - want[b]).max() <= tol * scale, b


def _pair(seed, n=N, m=None, shift=3.0):
    rng = np.random.RandomState(seed)
    m = m or n
    re = rng.randn(B, n, m).astype(np.float32)
    im = rng.randn(B, n, m).astype(np.float32)
    if n == m:
        re += np.float32(shift * np.sqrt(n)) * np.eye(n, dtype=np.float32)
    return re, im


def _hpd(seed, n=N):
    """Hermitian positive definite (re, im)."""
    rng = np.random.RandomState(seed)
    h = rng.randn(B, n, n) + 1j * rng.randn(B, n, n)
    p = h @ np.conj(np.swapaxes(h, 1, 2)) + n * np.eye(n)
    return p.real.astype(np.float32), p.imag.astype(np.float32)


@pytest.mark.parametrize("backend,tol", [("loop", 1e-5), ("auto", 1e-4)])
def test_solve_and_inverse_match_jax(backend, tol):
    a_re, a_im = _pair(0)
    rng = np.random.RandomState(1)
    b_re, b_im = (rng.randn(B, N).astype(np.float32) for _ in range(2))
    xj = jcx.solve_complex_batched(*_j(a_re, a_im, b_re, b_im),
                                   backend=backend)
    xt = tcx.solve_complex_batched(*_t(a_re, a_im, b_re, b_im),
                                   backend=backend)
    for got, want in zip(xt, xj):
        _close(got, want, tol)
    ij = jcx.inverse_complex_batched(*_j(a_re, a_im), backend=backend)
    it = tcx.inverse_complex_batched(*_t(a_re, a_im), backend=backend)
    for got, want in zip(it, ij):
        _close(got, want, tol)


@pytest.mark.parametrize("n", [1, 16, 33])
def test_gauss_pivots_plain_version_matches_jax(n):
    """Pivots within 1e-5 of the lane's largest, sign and ok exact, on
    Gaussian lanes, a lane with a zero first column (no pivot: ok False)
    and a lane scaled by 1e-3; the wrapper on CPU tensors is the plain
    version."""
    rng = np.random.RandomState(n)
    re = rng.randn(B, n, n).astype(np.float32)
    im = rng.randn(B, n, n).astype(np.float32)
    re[1, :, 0] = im[1, :, 0] = 0.0
    re[2] *= 1e-3
    im[2] *= 1e-3
    pj = [np.asarray(x) for x in jcx._gauss_pivots_complex(*_j(re, im))]
    pt = cg.gauss_pivots_complex_reference(*_t(re, im))
    _close(pt[0].numpy() + 1j * pt[1].numpy(), pj[0] + 1j * pj[1], 1e-5)
    np.testing.assert_array_equal(pt[2].numpy(), pj[2])
    np.testing.assert_array_equal(pt[3].numpy(), pj[3])
    assert not pt[3][1]
    wrapped = cg.gauss_pivots_complex(*_t(re, im))
    for got, want in zip(wrapped, pt):
        assert torch.equal(got, want)


def test_det_and_slogdet_match_jax():
    """det within 1e-5 of |det| (the products over the pivots run in
    another order than the reference's sequential loop); slogdet's phase
    and log|det| within 1e-5; a singular lane gives det 0, sign 0 and
    log|det| = −inf in both."""
    a_re, a_im = _pair(2, shift=0.5)
    a_re[3] = a_im[3] = 0.0
    dj = [np.asarray(x) for x in jcx.det_complex_batched(*_j(a_re, a_im))]
    dt = [x.numpy() for x in tcx.det_complex_batched(*_t(a_re, a_im))]
    wj, wt = dj[0] + 1j * dj[1], dt[0] + 1j * dt[1]
    assert np.abs(wt - wj).max() <= 1e-5 * np.abs(wj).max()
    assert wt[3] == 0
    sj = [np.asarray(x) for x in jcx.slogdet_complex_batched(*_j(a_re, a_im))]
    st = [x.numpy() for x in tcx.slogdet_complex_batched(*_t(a_re, a_im))]
    assert np.abs((st[0] + 1j * st[1]) - (sj[0] + 1j * sj[1])).max() <= 1e-5
    np.testing.assert_allclose(st[2][:3], sj[2][:3], rtol=1e-5)
    assert st[2][3] == sj[2][3] == -np.inf
    f = (tops.det_complex_batched, tops.solve_complex_batched,
         tops.inverse_complex_batched)
    assert f == (tcx.det_complex_batched, tcx.solve_complex_batched,
                 tcx.inverse_complex_batched)


def test_cholesky_and_qr_match_jax():
    p_re, p_im = _hpd(3)
    p_re[2, 0, 0] = -1.0                      # not positive definite
    cj = jcx.chol_complex_batched(*_j(p_re, p_im))
    ct = tcx.chol_complex_batched(*_t(p_re, p_im))
    np.testing.assert_array_equal(ct.ok.numpy(), np.asarray(cj.ok))
    ok = np.asarray(cj.ok)
    _close(ct.l_re.numpy()[ok], np.asarray(cj.l_re)[ok], 1e-5)
    _close(ct.l_im.numpy()[ok], np.asarray(cj.l_im)[ok], 1e-5)
    t_re, t_im = _pair(4, n=12, m=6)
    qj = jcx.qr_complex_batched(*_j(t_re, t_im))
    qt = tcx.qr_complex_batched(*_t(t_re, t_im))
    for f in qj._fields[:4]:
        _close(getattr(qt, f), getattr(qj, f), 1e-4)
    np.testing.assert_array_equal(qt.ok.numpy(), np.asarray(qj.ok))


@pytest.mark.parametrize("shape", [(12, 6), (6, 12)])
def test_pinv_and_lstsq_match_jax(shape):
    m, n = shape
    t_re, t_im = _pair(5, n=m, m=n)
    rng = np.random.RandomState(6)
    b_re, b_im = (rng.randn(B, m).astype(np.float32) for _ in range(2))
    pj = jcx.pinv_complex_batched(*_j(t_re, t_im))
    pt = tcx.pinv_complex_batched(*_t(t_re, t_im))
    for got, want in zip(pt[:2], pj[:2]):
        _close(got, want, 1e-4)
    np.testing.assert_array_equal(pt[2].numpy(), np.asarray(pj[2]))
    lj = jcx.lstsq_complex_batched(*_j(t_re, t_im, b_re, b_im))
    lt = tcx.lstsq_complex_batched(*_t(t_re, t_im, b_re, b_im))
    for got, want in zip(lt[:2], lj[:2]):
        _close(got, want, 1e-4)
    np.testing.assert_array_equal(lt[2].numpy(), np.asarray(lj[2]))


def test_solve_complex_dd_matches_jax():
    """The embedded dd solve: x within 1e-10 of ‖x‖ in float64, resid
    below the f64-class target and ok equal, on a system of κ ≈ 1e3."""
    rng = np.random.RandomState(7)
    a = []
    for _ in range(B):
        u, _ = np.linalg.qr(rng.randn(N, N) + 1j * rng.randn(N, N))
        v, _ = np.linalg.qr(rng.randn(N, N) + 1j * rng.randn(N, N))
        a.append(u @ np.diag(np.logspace(0, -3, N)) @ np.conj(v.T))
    a = np.array(a)
    a_re, a_im = a.real.astype(np.float32), a.imag.astype(np.float32)
    b_re, b_im = (rng.randn(B, N).astype(np.float32) for _ in range(2))
    xj = jcx.solve_complex_dd_batched(*_j(a_re, a_im, b_re, b_im))
    xt = tcx.solve_complex_dd_batched(*_t(a_re, a_im, b_re, b_im))
    np.testing.assert_array_equal(xt[3].numpy(), np.asarray(xj[3]))
    assert xt[3].all()
    _close(xt[0].numpy() + 1j * xt[1].numpy(),
           np.asarray(xj[0], np.float64) + 1j * np.asarray(xj[1], np.float64),
           1e-6)
    # the collapsed f32 result is as close as f32 holds it; the f64-class
    # check is on the real embedding, whose hi + lo the dd solve returns
    from linalg_solver_tpu.ops import dd as jdd
    from linalg_solver_tpu_torch.ops import dd as tdd
    M = np.asarray(jcx._embed(*_j(a_re, a_im)))
    rhs = np.concatenate([b_re, b_im], axis=1)
    rj = jdd.solve_dd_batched(jnp.asarray(M), jnp.asarray(rhs))
    rt = tdd.solve_dd_batched(*_t(M, rhs))
    x_j = np.asarray(rj.x_hi, np.float64) + np.asarray(rj.x_lo, np.float64)
    x_t = rt.x_hi.double().numpy() + rt.x_lo.double().numpy()
    _close(x_t, x_j, 1e-10)
    assert (xt[2].numpy() <= 1e-10 * np.abs(rhs).max()).all()


def test_complete_basis_matches_jax_with_its_draw():
    """Fed the reference's PRNGKey(7) draw, the complement matches the JAX
    package's to 1e-4; with its own default draw it is still a unitary
    completion."""
    t_re, t_im = _pair(8, n=12, m=5)
    q = jcx.qr_complex_batched(*_j(t_re, t_im))
    u_re, u_im = np.asarray(q.q_re), np.asarray(q.q_im)
    kr, ki = jax.random.split(jax.random.PRNGKey(7))
    w_re = np.asarray(jax.random.normal(kr, (12, 7), jnp.float32))
    w_im = np.asarray(jax.random.normal(ki, (12, 7), jnp.float32))
    cj = jcx.complete_basis_complex_batched(*_j(u_re, u_im))
    ct = tcx.complete_basis_complex_batched(*_t(u_re, u_im, w_re, w_im))
    for got, want in zip(ct, cj):
        _close(got, want, 1e-4)
    c_re, c_im = tcx.complete_basis_complex_batched(*_t(u_re, u_im))
    full = np.concatenate([u_re + 1j * u_im,
                           c_re.numpy() + 1j * c_im.numpy()], axis=2)
    gram = np.conj(np.swapaxes(full, 1, 2)) @ full
    assert np.abs(gram - np.eye(12)).max() <= 1e-5
