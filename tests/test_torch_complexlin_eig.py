"""The port's complex layer (``linalg_solver_tpu_torch.ops.complexlin``),
its spectral half, against the JAX package on the same numpy inputs:
Hermitian and general eigendecompositions (with the degenerate repair
and the conjugate-partner selection on the host), the SVD, the matrix
functions, Sylvester and Lyapunov, the generalized problem and roots.

Spectra are compared as matched multisets (one-to-one by
``linear_sum_assignment``), within 1e-4·‖A‖; values within 1e-4 of the
largest entry of the JAX result a lane (eigenvectors through the
residual ‖Av − λv‖, since each is determined up to a phase); ``ok`` flags
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm
from scipy.optimize import linear_sum_assignment

from linalg_solver_tpu.ops import complexlin as jcx
from linalg_solver_tpu_torch.ops import complexlin as tcx

B, N = 4, 8
TOL = 1e-4


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _c(x):
    x = np.asarray(x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def _close(got, want, tol=TOL):
    want, got = _c(want), _c(got)
    assert got.shape == want.shape
    for b in range(want.shape[0]):
        scale = max(np.abs(want[b]).max(), 1e-30)
        assert np.abs(got[b] - want[b]).max() <= tol * scale, b


def _same_spectra(got, want, scale):
    for b in range(want.shape[0]):
        cost = np.abs(got[b][:, None] - want[b][None, :])
        r, c = linear_sum_assignment(cost)
        assert cost[r, c].max() <= TOL * scale[b], b


def _spec(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _pair(seed, n=N, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    re = (scale * rng.randn(B, n, n)
          + shift * np.eye(n)).astype(np.float32)
    im = (scale * rng.randn(B, n, n)).astype(np.float32)
    return re, im


def _hermitian(seed):
    re, im = _pair(seed)
    return ((re + np.swapaxes(re, 1, 2)) / 2).astype(np.float32), \
        ((im - np.swapaxes(im, 1, 2)) / 2).astype(np.float32)


def _norm(re, im):
    return (np.abs(re) + np.abs(im)).max(axis=(1, 2))


def _eig_resid(a_re, a_im, w, v):
    a = _spec(a_re, a_im)
    r = a @ v - v * w[:, None, :]
    return np.abs(r).max(axis=1).max(axis=1) / _norm(a_re, a_im)


def test_eigh_matches_jax_with_a_degenerate_lane():
    """Ascending eigenvalues within 1e-4·‖A‖, eigenvectors by residual;
    lane 3 has a doubled eigenvalue (A = diag(1, 1, 2, …) under a unitary
    similarity), which the every-other selection may pick twice: both
    packages repair it on the host and report ok."""
    h_re, h_im = _hermitian(0)
    rng = np.random.RandomState(9)
    q, _ = np.linalg.qr(rng.randn(N, N) + 1j * rng.randn(N, N))
    d = np.diag([1.0, 1.0] + list(range(2, N)))
    h = q @ d @ np.conj(q.T)
    h_re[3], h_im[3] = h.real, h.imag
    rj = jcx.eigh_complex_batched(*_j(h_re, h_im))
    rt = tcx.eigh_complex_batched(*_t(h_re, h_im))
    scale = _norm(h_re, h_im)
    assert (np.abs(rt.w.numpy() - np.asarray(rj.w)).max(axis=1)
            <= TOL * scale).all()
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.all()
    v = rt.v_re.double().numpy() + 1j * rt.v_im.double().numpy()
    assert (_eig_resid(h_re, h_im, rt.w.double().numpy(), v) <= 1e-5).all()


def test_eig_matches_jax_on_complex_and_real_input():
    """Gaussian complex lanes and a real lane (S = S̄: every embedded
    column has ‖u‖ ~ 1, where a top-n rule would return λ twice): the
    spectra as multisets, ok equal, every residual small."""
    a_re, a_im = _pair(1)
    a_im[2] = 0.0
    rj = jcx.eig_complex_batched(*_j(a_re, a_im))
    rt = tcx.eig_complex_batched(*_t(a_re, a_im))
    _same_spectra(_spec(rt.real, rt.imag), _spec(rj.real, rj.imag),
                  _norm(a_re, a_im))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.all()
    v = rt.v_re.double().numpy() + 1j * rt.v_im.double().numpy()
    w = _spec(rt.real, rt.imag)
    assert (_eig_resid(a_re, a_im, w, v) <= 1e-4).all()


@pytest.mark.parametrize("shape", [(12, 6), (6, 12)])
def test_svd_matches_jax(shape):
    m, n = shape
    rng = np.random.RandomState(2)
    a_re, a_im = (rng.randn(B, m, n).astype(np.float32) for _ in range(2))
    rj = jcx.svd_complex_batched(*_j(a_re, a_im))
    rt = tcx.svd_complex_batched(*_t(a_re, a_im))
    _close(rt.s, rj.s)
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    u = rt.u_re.double().numpy() + 1j * rt.u_im.double().numpy()
    v = rt.v_re.double().numpy() + 1j * rt.v_im.double().numpy()
    rec = (u * rt.s.double().numpy()[:, None, :]) @ np.conj(
        np.swapaxes(v, 1, 2))
    a = _spec(a_re, a_im)
    assert (np.abs(rec - a).max(axis=(1, 2)) <= TOL * _norm(a_re, a_im)).all()


@pytest.mark.parametrize("name,shift", [("expm", 0.0), ("sqrtm", 2.0),
                                        ("logm", 2.0)])
def test_matrix_functions_match_jax(name, shift):
    a_re, a_im = _pair(3, scale=0.3, shift=shift)
    fj = getattr(jcx, name + "_complex_batched")(*_j(a_re, a_im))
    ft = getattr(tcx, name + "_complex_batched")(*_t(a_re, a_im))
    _close(ft[0].numpy() + 1j * ft[1].numpy(),
           np.asarray(fj[0]) + 1j * np.asarray(fj[1]))
    np.testing.assert_array_equal(ft[2].numpy(), np.asarray(fj[2]))


def test_funm_hermitian_and_general_match_jax():
    h_re, h_im = _hermitian(4)
    h_re, h_im = 0.2 * h_re, 0.2 * h_im
    hj = jcx.funm_hermitian_batched(*_j(h_re, h_im), jnp.exp)
    ht = tcx.funm_hermitian_batched(*_t(h_re, h_im), torch.exp)
    _close(ht[0].numpy() + 1j * ht[1].numpy(),
           np.asarray(hj[0]) + 1j * np.asarray(hj[1]))
    np.testing.assert_array_equal(ht[2].numpy(), np.asarray(hj[2]))
    # the general form's V⁻¹ is the embedded inverse on "auto": kernel 2's
    # pivot-free RBT inverse here (as the reference routes it on its
    # chip, under its 1e-2 gate), the loop in the JAX package on a CPU;
    # on lane 0 of this input the RBT inverse leaves max|V V⁻¹ − I| =
    # 1.4e-4 (κ(V) = 3.1), so each package is held to scipy's float64
    # expm within 10× its own reported reconstruction error ``resid``
    # (plus 1e-5), and the flags must agree
    a_re, a_im = _pair(5, scale=0.3)
    gj = jcx.funm_complex_batched(*_j(a_re, a_im), jnp.exp)
    gt = tcx.funm_complex_batched(*_t(a_re, a_im), torch.exp)
    want = np.array([expm(x) for x in _spec(a_re, a_im)])
    scale = np.abs(want).max(axis=(1, 2))
    for f in (gj, gt):
        got = _spec(f[0], f[1])
        err = np.abs(got - want).max(axis=(1, 2)) / scale
        assert (err <= 10 * np.asarray(f[2]) + 1e-5).all()
    np.testing.assert_array_equal(gt[3].numpy(), np.asarray(gj[3]))
    assert gt[3].all()


def test_sylvester_and_lyapunov_match_jax():
    a_re, a_im = _pair(6, shift=3.0)
    b_re, b_im = _pair(7, shift=3.0)
    c_re, c_im = _pair(8)
    xj = jcx.sylvester_complex_batched(*_j(a_re, a_im, b_re, b_im,
                                           c_re, c_im))
    xt = tcx.sylvester_complex_batched(*_t(a_re, a_im, b_re, b_im,
                                           c_re, c_im))
    _close(xt[0].numpy() + 1j * xt[1].numpy(),
           np.asarray(xj[0]) + 1j * np.asarray(xj[1]))
    np.testing.assert_array_equal(xt[2].numpy(), np.asarray(xj[2]))
    q_re, q_im = _hermitian(9)
    lj = jcx.lyapunov_complex_batched(*_j(a_re, a_im, q_re, q_im))
    lt = tcx.lyapunov_complex_batched(*_t(a_re, a_im, q_re, q_im))
    _close(lt[0].numpy() + 1j * lt[1].numpy(),
           np.asarray(lj[0]) + 1j * np.asarray(lj[1]))
    np.testing.assert_array_equal(lt[2].numpy(), np.asarray(lj[2]))
    assert lt[2].all()


def test_generalized_eig_and_roots_match_jax():
    a_re, a_im = _pair(10)
    b_re, b_im = _pair(11, shift=3.0 * np.sqrt(N))
    gj = jcx.eig_generalized_complex_batched(*_j(a_re, a_im, b_re, b_im))
    gt = tcx.eig_generalized_complex_batched(*_t(a_re, a_im, b_re, b_im))
    _same_spectra(_spec(gt.real, gt.imag), _spec(gj.real, gj.imag),
                  np.abs(_spec(gj.real, gj.imag)).max(axis=1))
    np.testing.assert_array_equal(gt.ok.numpy(), np.asarray(gj.ok))
    np.testing.assert_allclose(gt.rcond_b.numpy(), np.asarray(gj.rcond_b),
                               rtol=TOL)
    rng = np.random.RandomState(12)
    c_re, c_im = (rng.randn(B, 7).astype(np.float32) for _ in range(2))
    c_re[1, 0] = c_im[1, 0] = 0.0             # leading zero: not ok
    rj = jcx.roots_complex_batched(*_j(c_re, c_im))
    rt = tcx.roots_complex_batched(*_t(c_re, c_im))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    ok = np.asarray(rj.ok)
    assert not ok[1]
    want = _spec(rj.real, rj.imag)[ok]
    _same_spectra(_spec(rt.real, rt.imag)[ok], want,
                  np.abs(want).max(axis=1))
