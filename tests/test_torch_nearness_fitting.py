"""The port's nearness problems and fitting routines
(``linalg_solver_tpu_torch.ops.nearness``, ``ops.fitting``) against the
JAX package, fed the same numpy inputs.

Values within 1e-4 of the largest entry of the JAX package's (TLS's σ_min
within 1e-4 of the lane's largest singular value); ``ok``,
``converged`` exact.  The nearest correlation's iteration counts may
differ by a step (the port's eigensolver runs in float64, the JAX
package's in float32); its result is also held to the fixed point's
properties: unit diagonal and PSD."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import fitting as jfit
from linalg_solver_tpu.ops import nearness as jnr
from linalg_solver_tpu_torch.ops import fitting as tfit
from linalg_solver_tpu_torch.ops import nearness as tnr

B = 3
TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    for b in range(want.shape[0]):
        assert np.abs(got[b] - want[b]).max() <= tol * max(
            np.abs(want[b]).max(), 1e-30)


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _corrupted(n=10, k=4, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(B, n, k)
    c = g @ g.transpose(0, 2, 1)
    d = np.sqrt(np.einsum("bii->bi", c))
    return (c / (d[:, :, None] * d[:, None, :])
            + 0.3 * rng.randn(B, n, n)).astype(np.float32)


@pytest.mark.parametrize("shift", [0.0, 1e-3])
def test_nearest_psd_matches_jax(shift):
    a = _corrupted(seed=1)
    rj = jnr.nearest_psd_batched(jnp.asarray(a), shift)
    rt = tnr.nearest_psd_batched(_t(a), shift)
    assert rt._fields == rj._fields
    _close(rt.x, rj.x)
    _close(rt.distance[:, None], np.asarray(rj.distance)[:, None])
    w = np.linalg.eigvalsh(rt.x.double().numpy())
    assert w.min() > (shift * np.abs(w).max(axis=1).min() * 0.5
                      if shift else -1e-5)


def test_nearest_correlation_matches_jax():
    a = _corrupted(seed=2)
    rj = jnr.nearest_correlation_batched(jnp.asarray(a))
    rt = tnr.nearest_correlation_batched(_t(a))
    assert rt._fields == rj._fields
    _exact(rt.converged, rj.converged)
    assert bool(rt.converged.all())
    assert abs(int(rt.iters) - int(rj.iters)) <= 1
    _close(rt.x, rj.x, tol=1e-4)
    _close(rt.distance[:, None], np.asarray(rj.distance)[:, None])
    X = rt.x.double().numpy()
    assert np.abs(np.einsum("bii->bi", X) - 1).max() < 1e-5
    assert np.linalg.eigvalsh(X).min() > -1e-6


def test_nearest_orthogonal_matches_jax():
    rng = np.random.RandomState(4)
    a = (rng.randn(B, 7, 7) + 2 * np.eye(7)).astype(np.float32)
    qj, dj, okj = jnr.nearest_orthogonal_batched(jnp.asarray(a))
    qt, dt, okt = tnr.nearest_orthogonal_batched(_t(a))
    _close(qt, qj)
    _close(dt[:, None], np.asarray(dj)[:, None])
    _exact(okt, okj)


@pytest.mark.parametrize("rhs", ["vector", "matrix", "per_lane_lambda"])
def test_ridge_matches_jax(rhs):
    rng = np.random.RandomState(5)
    a = rng.randn(B, 30, 8).astype(np.float32)
    b = rng.randn(B, 30, *(() if rhs != "matrix" else (3,))).astype(
        np.float32)
    lam = (np.array([0.1, 1.0, 10.0], np.float32) if rhs == "per_lane_lambda"
           else 0.5)
    rj = jfit.ridge_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lam))
    rt = tfit.ridge_batched(_t(a), _t(b), lam if np.isscalar(lam) else
                            _t(lam))
    assert rt._fields == rj._fields
    _close(rt.x, rj.x)
    _exact(rt.ok, rj.ok)


def test_tls_matches_jax():
    rng = np.random.RandomState(6)
    a = rng.randn(B, 30, 8).astype(np.float32)
    b = (np.einsum("bmn,bn->bm", a, rng.randn(B, 8))
         + 0.01 * rng.randn(B, 30)).astype(np.float32)
    b[2] = 0.0                      # x = 0 exactly solves it: degenerate
    a[2, :, 0] = 0.0
    rj = jfit.tls_batched(jnp.asarray(a), jnp.asarray(b))
    rt = tfit.tls_batched(_t(a), _t(b))
    assert rt._fields == rj._fields
    _exact(rt.ok, rj.ok)
    _close(rt.x[:2], np.asarray(rj.x)[:2])
    # σ_min within 1e-4 of the lane's largest singular value (the scale
    # both eigensolvers round it at)
    smax = np.linalg.norm(np.concatenate([a, b[:, :, None]], 2), 2,
                          axis=(1, 2))
    assert (np.abs(rt.sigma.double().numpy() - np.asarray(rj.sigma))
            <= TOL * smax).all()


@pytest.mark.parametrize("with_scale", [False, True])
def test_procrustes_matches_jax(with_scale):
    rng = np.random.RandomState(7)
    a = rng.randn(B, 6, 20).astype(np.float32)
    r = np.linalg.qr(rng.randn(B, 6, 6))[0]
    b = (2.5 * r @ a + 0.01 * rng.randn(B, 6, 20)).astype(np.float32)
    rj = jfit.procrustes_batched(jnp.asarray(a), jnp.asarray(b),
                                 with_scale=with_scale)
    rt = tfit.procrustes_batched(_t(a), _t(b), with_scale=with_scale)
    assert rt._fields == rj._fields
    _close(rt.Q, rj.Q)
    _close(rt.scale[:, None], np.asarray(rj.scale)[:, None])
    _exact(rt.ok, rj.ok)


@pytest.mark.parametrize("noise", [1.0, 1e-3])
def test_subspace_angles_match_jax(noise):
    """Generic angles (the cosine path) and small ones (the sine path)."""
    rng = np.random.RandomState(8)
    u = rng.randn(B, 20, 4).astype(np.float32)
    v = np.concatenate([u, rng.randn(B, 20, 2)], axis=2)
    v = (v + noise * rng.randn(*v.shape)).astype(np.float32)
    rj = jfit.subspace_angles_batched(jnp.asarray(u), jnp.asarray(v))
    rt = tfit.subspace_angles_batched(_t(u), _t(v))
    assert rt._fields == rj._fields
    _exact(rt.ok, rj.ok)
    want = np.asarray(rj.angles, np.float64)
    assert np.abs(rt.angles.double().numpy() - want).max() <= TOL * max(
        np.abs(want).max(), 1e-3)
