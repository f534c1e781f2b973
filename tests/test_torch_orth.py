"""The port's masked orthonormalization (``linalg_solver_tpu_torch.ops
.orth``) against the JAX package's ``ops.orth``, fed the same numpy
inputs.

Exact: the compaction (an index scatter against the reference's one-hot
product: both move the same f32 values), ``d``, and the lanes whose
basis comes back non-finite (a Gram matrix that is not positive
definite: NaN where the reference's Cholesky gives NaN).  Values: Q
within 1e-4 of its largest entry (CholeskyQR is deterministic: no sign
is free)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import orth as jorth
from linalg_solver_tpu_torch.ops import orth as torth

RTOL = 1e-4


def _gens(B, n, seed):
    rng = np.random.RandomState(seed)
    gens = rng.randn(B, n, n).astype(np.float32)
    gmask = rng.rand(B, n) > 0.4
    gmask[0] = False          # an empty set
    gmask[1, :] = True        # a full one
    return gens, gmask


def test_compact_columns_matches_jax_exactly():
    gens, gmask = _gens(4, 7, seed=1)
    want = np.asarray(jorth.compact_columns(jnp.asarray(gens),
                                            jnp.asarray(gmask)))
    got = torth.compact_columns(torch.from_numpy(gens),
                                torch.from_numpy(gmask)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [6, 12])
def test_orthonormal_columns_matches_jax(n):
    gens, gmask = _gens(4, n, seed=n)
    qj, dj = jorth.orthonormal_columns(jnp.asarray(gens), jnp.asarray(gmask))
    qt, dt = torth.orthonormal_columns(torch.from_numpy(gens),
                                       torch.from_numpy(gmask))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    qj = np.asarray(qj)
    assert np.abs(qt.numpy() - qj).max() <= RTOL * np.abs(qj).max()
    # the first d columns orthonormal, the rest exactly zero
    for i, d in enumerate(dt.tolist()):
        q = qt[i].double()
        gram = q[:, :d].T @ q[:, :d] - torch.eye(d, dtype=torch.float64)
        assert d == 0 or float(gram.abs().max()) <= 1e-5
        assert bool((q[:, d:] == 0).all())


def test_ill_conditioned_generators_stay_finite_in_both():
    """Near-parallel columns of size 4e3 with 1e-2 independent parts:
    the shifted first pass keeps the Gram matrix positive definite in
    both packages, and both bases span the generators."""
    rng = np.random.RandomState(0)
    n, d = 32, 3
    base = rng.randn(n)
    gens = np.zeros((1, n, n), np.float32)
    for j in range(d):
        gens[0, :, j] = 4e3 * base + 1e-2 * rng.randn(n)
    gmask = np.zeros((1, n), bool)
    gmask[0, :d] = True
    qj, dj = jorth.orthonormal_columns(jnp.asarray(gens), jnp.asarray(gmask))
    qt, dt = torth.orthonormal_columns(torch.from_numpy(gens),
                                       torch.from_numpy(gmask))
    assert np.isfinite(np.asarray(qj)).all() and bool(torch.isfinite(qt).all())
    assert int(dt[0]) == int(dj[0]) == d
    G = gens[0, :, :d].astype(np.float64)
    for q in (np.asarray(qj)[0, :, :d], qt[0, :, :d].numpy()):
        q = q.astype(np.float64)
        assert np.linalg.norm(G - q @ (q.T @ G)) <= 1e-3 * np.linalg.norm(G)


def test_failed_cholesky_is_nan_in_the_same_lanes():
    """A masked zero column makes the unshifted Gram matrix singular:
    the reference's Cholesky returns NaN for that lane, and the port's
    ``cholesky_ex`` path must too (``torch.linalg.cholesky`` would
    raise); the other lane stays finite and equal."""
    rng = np.random.RandomState(3)
    g = rng.randn(2, 6, 6).astype(np.float32)
    g[1, :, 2] = 0.0
    colmask = np.zeros((2, 6), np.float32)
    colmask[:, :4] = 1.0
    qj = np.asarray(jorth._chol_qr(jnp.asarray(g), jnp.asarray(colmask)))
    qt = torth._chol_qr(torch.from_numpy(g), torch.from_numpy(colmask)).numpy()
    np.testing.assert_array_equal(np.isnan(qt), np.isnan(qj))
    assert np.isnan(qt[1]).any() and np.isfinite(qt[0]).all()
    assert np.abs(qt[0] - qj[0]).max() <= RTOL * np.abs(qj[0]).max()
