"""The port's randomized SVD, interpolative decomposition and CUR
(``ops.randomized``) against the JAX package's on the JAX tests' seeded
low-rank-plus-noise batches, the JAX package's Gaussian sketch and probes
(``PRNGKey(0)``) handed to the port:

- singular values to 1e-5 of σ₁, the rank-k reconstructions to 1e-5 of
  max|A|, the residual estimate to 1e-3 relative, ``ok`` and ``valid``
  equal, k at the rank and past it;
- ID and CUR: the same columns and rows, the relative Frobenius error
  to 1e-5, ``ok`` equal;
- the default draw (a ``torch.Generator``) gives the same accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import randomized as jr
from linalg_solver_tpu_torch.ops import randomized as tr


def lowrank_plus_noise(B, m, n, r, noise, seed=0):
    rng = np.random.RandomState(seed)
    L = rng.randn(B, m, r) @ rng.randn(B, r, n)
    return (L + noise * rng.randn(B, m, n)).astype(np.float32)


def _jax_draws(B, n, ell):
    key = jax.random.PRNGKey(0)
    omega = np.array(jax.random.normal(key, (B, n, ell), jnp.float32))
    probes = np.array(jax.random.normal(jax.random.split(key)[1],
                                        (B, n, 4), jnp.float32))
    return torch.from_numpy(omega), torch.from_numpy(probes)


def _rec(U, s, V):
    return np.einsum("bik,bk,bjk->bij", U, s, V)


@pytest.mark.parametrize("k, noise", [(5, 0.0), (12, 1e-3)])
def test_randomized_svd_matches(k, noise):
    B, m, n, r = 3, 60, 40, 5
    A = lowrank_plus_noise(B, m, n, r, noise, seed=1)
    want = jr.randomized_svd_batched(jnp.asarray(A), k=k)
    omega, probes = _jax_draws(B, n, min(k + 8, n))
    got = tr.randomized_svd_batched(torch.from_numpy(A), k=k, omega=omega,
                                    probes=probes)
    s, sj = got.s.numpy(), np.asarray(want.s)
    assert np.abs(s - sj).max() <= 1e-5 * sj[:, 0].max()
    scale = np.abs(A).max()
    rec = _rec(got.U.numpy(), s, got.V.numpy())
    assert np.abs(rec - _rec(np.asarray(want.U), sj,
                             np.asarray(want.V))).max() <= 1e-5 * scale
    np.testing.assert_allclose(got.resid_est.numpy(),
                               np.asarray(want.resid_est), rtol=1e-3,
                               atol=1e-6 * scale)
    assert np.array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert bool(got.ok.all())


def test_default_draw_is_as_accurate():
    B, m, n, r = 2, 50, 50, 8
    rng = np.random.RandomState(2)
    Uq, _ = np.linalg.qr(rng.randn(m, m))
    Vq, _ = np.linalg.qr(rng.randn(n, n))
    sv = np.power(0.5, np.arange(n))
    A = np.broadcast_to((Uq[:, :n] * sv) @ Vq.T, (B, m, n)).astype(
        np.float32).copy()
    got = tr.randomized_svd_batched(torch.from_numpy(A), k=r)
    for i in range(B):
        np.testing.assert_allclose(got.s[i].numpy(), sv[:r], rtol=1e-3)
        rec = (got.U[i].numpy() * got.s[i].numpy()) @ got.V[i].numpy().T
        assert np.linalg.norm(A[i] - rec, 2) < 3.0 * sv[r]
    with pytest.raises(ValueError, match="exceeds"):
        tr.randomized_svd_batched(torch.from_numpy(A), k=51)


@pytest.mark.parametrize("name", ["interpolative_batched", "cur_batched"])
def test_id_and_cur_match(name):
    A = lowrank_plus_noise(3, 60, 40, 5, 1e-3, seed=4)
    want = getattr(jr, name)(jnp.asarray(A), 5)
    got = getattr(tr, name)(torch.from_numpy(A), 5)
    assert np.array_equal(got.cols.numpy(), np.asarray(want.cols))
    if name == "cur_batched":
        assert np.array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_allclose(got.resid_fro.numpy(),
                               np.asarray(want.resid_fro), rtol=1e-3)
    assert float(got.resid_fro.max()) < 1e-3
    assert np.array_equal(got.ok.numpy(), np.asarray(want.ok))
