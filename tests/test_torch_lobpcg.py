"""The port's LOBPCG (``linalg_solver_tpu_torch.ops.lobpcg``) against the
JAX package's ``ops.lobpcg`` on the same numpy inputs, fed the JAX
package's random draws (``PRNGKey(0)``: the start block, the first
basis's third block, each step's refresh directions).

The port's projected eigenproblem runs in float64 (the JAX package's in
float32), so the two differ by rounding: eigenvalues agree to 1e-5
relative, ``iters`` and ``converged`` exactly, residuals both under
tolerance, and the eigenvector spans to 1e-2 (principal angles; the
residual bound tol·‖A‖ / gap allows 0.07 on the hard lane).  The chunked
loop reads the host at most ⌈iters / CHUNK⌉ + 1 times."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import lobpcg as jl
from linalg_solver_tpu_torch.ops import krylov, lobpcg


def _spd(B, n, w, seed):
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(B, n, n))
    return np.einsum("bik,k,bjk->bij", Q, w, Q).astype(np.float32)


def _jax_draws(B, n, k, nguard):
    kk = min(k + nguard, n // 3)
    key = jax.random.PRNGKey(0)

    def t(x):
        return torch.from_numpy(np.array(x))

    x0 = t(jax.random.normal(key, (B, n, kk), jnp.float32))
    s0 = t(jax.random.normal(jax.random.fold_in(key, 17), (B, n, kk),
                             jnp.float32))
    return dict(x0=x0, s0=s0, refresh=lambda it: t(jax.random.normal(
        jax.random.fold_in(key, it), (B, n, 3 * kk), jnp.float32)))


def _span_gap(U, V):
    """sin of the largest principal angle between the column spans."""
    s = np.linalg.svd(np.asarray(U, np.float64).T
                      @ np.asarray(V, np.float64), compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


@pytest.mark.parametrize("largest", [False, True])
def test_lobpcg_matches_jax(largest):
    """One easy lane (a wide gap after the wanted pair) and one hard
    (a gap of 0.05), n = 40, k = 2."""
    n, k = 40, 2
    w_easy = np.concatenate([[1.0, 2.0], np.linspace(50, 99, n - 2)])
    w_hard = np.concatenate([[1.0, 1.05], np.linspace(1.2, 99, n - 2)])
    if largest:
        w_easy, w_hard = 100.0 - w_easy, 100.0 - w_hard
    a = np.concatenate([_spd(1, n, w_easy, 5), _spd(1, n, w_hard, 6)])
    krylov.reset_host_reads()
    rt = lobpcg.lobpcg_batched(torch.from_numpy(a), k, largest=largest,
                               tol=1e-4, max_iters=400,
                               **_jax_draws(2, n, k, 2))
    reads = krylov.HOST_READS
    rj = jl.lobpcg_batched(jnp.asarray(a), k, largest=largest, tol=1e-4,
                           max_iters=400)
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist() == [
        True, True]
    assert int(rt.iters) == int(rj.iters)
    assert reads <= math.ceil(int(rt.iters) / lobpcg.CHUNK) + 1
    want = np.stack([np.sort(w_easy)[-k:] if largest else np.sort(w_easy)[:k],
                     np.sort(w_hard)[-k:] if largest else np.sort(w_hard)[:k]])
    assert np.abs(rt.w.numpy() - np.asarray(rj.w)).max() <= 1e-5 * 100
    assert np.abs(rt.w.numpy() - want).max() <= 1e-3 * 100
    for i in range(2):
        assert _span_gap(rt.V[i], np.asarray(rj.V)[i]) <= 1e-2
    assert float(rt.resnorm.max()) <= 4e-4


def test_lobpcg_default_draws_and_a_nan_lane():
    """The port's own draws (a seeded CPU generator): the eigenvalues
    agree with numpy's; a NaN lane runs the loop to ``max_iters`` on both
    packages and is not converged, the others are."""
    n, k = 30, 3
    w = np.linspace(1.0, 30.0, n)
    a = _spd(3, n, w, 7)
    a[1, 2, 3] = a[1, 3, 2] = np.nan
    rt = lobpcg.lobpcg_batched(torch.from_numpy(a), k, tol=1e-4,
                               max_iters=40)
    rj = jl.lobpcg_batched(jnp.asarray(a), k, tol=1e-4, max_iters=40)
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist() == [
        True, False, True]
    assert int(rt.iters) == int(rj.iters) == 40
    assert np.abs(rt.w.numpy()[[0, 2]] - w[:k]).max() <= 1e-3
    with pytest.raises(ValueError, match="3k <= n"):
        lobpcg.lobpcg_batched(torch.from_numpy(a), 11)
