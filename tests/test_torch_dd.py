"""The port's f64-class layer (``linalg_solver_tpu_torch.ops.dd``, native
float64) against the JAX package's (Ozaki slices and float-float pairs)
on the same numpy inputs.

Each result is compared as ``hi + lo`` in float64: within 1e-10·‖x‖ of
the JAX package's (both are within ~1e-12 of the true solution at κ ≤
1e3), with the ``ok`` flags equal, a singular lane included; the
eigenvalues as matched multisets within 1e-10·‖A‖ on a separated
spectrum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from linalg_solver_tpu.ops import dd as jdd
from linalg_solver_tpu_torch.ops import dd as tdd

B = 4
TOL = 1e-10


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _hilo(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _conditioned(n, kappa, seed, singular_lane=None):
    """Orthogonal factors around logspace(0, −log10 κ), float32."""
    rng = np.random.RandomState(seed)
    a = []
    for _ in range(B):
        u, _ = np.linalg.qr(rng.randn(n, n))
        v, _ = np.linalg.qr(rng.randn(n, n))
        a.append(u @ np.diag(np.logspace(0, -np.log10(kappa), n)) @ v.T)
    a = np.array(a, np.float32)
    if singular_lane is not None:
        a[singular_lane] = 0.0
    return a


def _agree(got, want, tol=TOL):
    for b in range(want.shape[0]):
        assert np.abs(got[b] - want[b]).max() <= tol * np.abs(want[b]).max()


@pytest.mark.parametrize("n", [64, 15])
def test_solve_matches_jax(n):
    """N = 64 takes the phase route (panel kernel 6's plain version),
    N = 15 the LU loop; lane 3 is singular: ok False in both."""
    a = _conditioned(n, 1e3, seed=n, singular_lane=3)
    b = np.random.RandomState(1).randn(B, n).astype(np.float32)
    rj = jdd.solve_dd_batched(jnp.asarray(a), jnp.asarray(b))
    rt = tdd.solve_dd_batched(*_t(a, b))
    assert rt._fields == rj._fields
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.numpy().tolist() == [True, True, True, False]
    _agree(_hilo(rt.x_hi, rt.x_lo)[:3], _hilo(rj.x_hi, rj.x_lo)[:3])
    x64 = np.linalg.solve(a[:3].astype(np.float64), b[:3, :, None])[..., 0]
    _agree(_hilo(rt.x_hi, rt.x_lo)[:3], x64, 1e-12)
    assert rt.resid.dtype == torch.float32
    assert (rt.resid[:3].numpy() <= 1e-10 * np.abs(b[:3]).max()).all()


def test_inverse_matches_jax():
    a = _conditioned(32, 1e3, seed=2)
    rj = jdd.inverse_dd_batched(jnp.asarray(a))
    rt = tdd.inverse_dd_batched(*_t(a))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.all()
    _agree(_hilo(rt.x_hi, rt.x_lo), _hilo(rj.x_hi, rj.x_lo))
    assert (rt.resid.numpy() <= 1e-12).all()


def test_lstsq_matches_jax():
    """m = 48, n = 16; lane 2 has a zero column (rank-deficient: ok False
    in both)."""
    rng = np.random.RandomState(3)
    a = rng.randn(B, 48, 16).astype(np.float32)
    a[2, :, 5] = 0.0
    b = rng.randn(B, 48).astype(np.float32)
    rj = jdd.lstsq_dd_batched(jnp.asarray(a), jnp.asarray(b))
    rt = tdd.lstsq_dd_batched(*_t(a, b))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert not rt.ok[2] and rt.ok[[0, 1, 3]].all()
    keep = [0, 1, 3]
    _agree(_hilo(rt.x_hi, rt.x_lo)[keep], _hilo(rj.x_hi, rj.x_lo)[keep])


def test_eigh_matches_jax():
    rng = np.random.RandomState(4)
    s = rng.randn(B, 16, 16)
    s = (s + np.swapaxes(s, 1, 2)).astype(np.float32)
    rj = jdd.eigh_dd_batched(jnp.asarray(s))
    rt = tdd.eigh_dd_batched(*_t(s))
    w_t, w_j = _hilo(rt.w, rt.w_lo), _hilo(rj.w, rj.w_lo)
    scale = np.abs(s).max(axis=(1, 2))
    assert (np.abs(w_t - w_j).max(axis=1) <= TOL * scale).all()
    w64 = np.linalg.eigvalsh(s.astype(np.float64))
    assert (np.abs(w_t - w64).max(axis=1) <= 1e-12 * scale).all()
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))


def test_eig_matches_jax_on_a_separated_spectrum():
    """n = 16: four real eigenvalues and six complex pairs, all at least
    0.5 apart, under a similarity of κ ≈ 10; the refined spectra as
    matched multisets within 1e-10·‖A‖ of the JAX package's and of the
    float64 spectrum, every eigenvalue valid, s within 1e-3 of the JAX
    package's."""
    rng = np.random.RandomState(5)
    a = []
    for _ in range(B):
        blocks = [np.array([[x]]) for x in (-3.0, -1.5, 1.0, 2.5)]
        for k in range(6):
            re, im = -2.5 + k, 0.5 + 0.25 * k
            blocks.append(np.array([[re, im], [-im, re]]))
        d = np.zeros((16, 16))
        i = 0
        for blk in blocks:
            m = blk.shape[0]
            d[i:i + m, i:i + m] = blk
            i += m
        q, _ = np.linalg.qr(rng.randn(16, 16))
        p = q @ np.diag(np.logspace(0, 1, 16)) @ q.T
        a.append(p @ d @ np.linalg.inv(p))
    a = np.array(a, np.float32)
    rj = jdd.eig_dd_batched(jnp.asarray(a))
    rt = tdd.eig_dd_batched(*_t(a))
    lj = _hilo(rj.lam_re, rj.lam_re_lo) + 1j * _hilo(rj.lam_im, rj.lam_im_lo)
    lt = _hilo(rt.lam_re, rt.lam_re_lo) + 1j * _hilo(rt.lam_im, rt.lam_im_lo)
    scale = np.abs(a).max(axis=(1, 2))
    for b in range(B):
        cost = np.abs(lt[b][:, None] - lj[b][None, :])
        r, c = linear_sum_assignment(cost)
        assert cost[r, c].max() <= TOL * scale[b]
        np.testing.assert_allclose(np.sort(rt.s[b].numpy()),
                                   np.sort(np.asarray(rj.s[b])), rtol=1e-3)
        # and the true spectrum of the float32 matrix, in float64
        cost = np.abs(lt[b][:, None]
                      - np.linalg.eigvals(a[b].astype(np.float64))[None, :])
        r, c = linear_sum_assignment(cost)
        assert cost[r, c].max() <= TOL * scale[b]
    assert rt.valid.all() and np.asarray(rj.valid).all()
    # the first-order bound resid / s rides on the f32 eigenvectors' own
    # residual (~1e-6), in both packages
    assert (rt.err_bound.numpy() <= 1e-4).all()
    assert (np.asarray(rj.err_bound) <= 1e-4).all()
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))


def test_matmul_dd_matches_jax():
    rng = np.random.RandomState(6)
    a = rng.randn(2, 24, 40).astype(np.float32)
    b = rng.randn(2, 40, 8).astype(np.float32)
    pj = jdd.matmul_dd_batched(jnp.asarray(a), jnp.asarray(b))
    pt = tdd.matmul_dd_batched(*_t(a, b))
    want = a.astype(np.float64) @ b.astype(np.float64)
    _agree(_hilo(pt.hi, pt.lo), want, 1e-14)   # a (hi, lo) pair: 48 bits
    _agree(_hilo(pt.hi, pt.lo), _hilo(pj.hi, pj.lo), 1e-13)
