"""The port's Krylov–Schur eigensolver (``linalg_solver_tpu_torch.ops.
arnoldi``) against the JAX package's ``ops.arnoldi`` on the same numpy
inputs, with the JAX package's draws injected: the start vector, and the
breakdown splice's directions (``PRNGKey(7)`` folded by step and by
restart, given to the port as ``splice``).

The two Schur solvers order a spectrum differently, so Ritz values are
compared sorted by the ``which`` key: they agree to 1e-4 of the largest
magnitude, the residuals from true matvecs are under tolerance on both,
and ``converged`` agrees.  One case breaks down on the second step (a
start vector inside a 3-dimensional invariant subspace), so the splice
directions decide the rest of the run."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import arnoldi as ja
from linalg_solver_tpu_torch.ops import arnoldi

N = 64


def _jax_splice(B, n, m):
    """``splice(it)`` of the JAX package's draws: restart ``it``'s key is
    PRNGKey(7) folded by 0, 1, …, it − 1; step j draws with fold_in(key,
    j)."""
    keys = [jax.random.PRNGKey(7)]

    def splice(it):
        while len(keys) <= it:
            keys.append(jax.random.fold_in(keys[-1], len(keys) - 1))
        return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(keys[it], j), (B, n), jnp.float32))
            for j in range(m)]))

    return splice


def _v0(B, n):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (B, n),
                                      jnp.float32))


def _sorted(res, which):
    lam = np.asarray(res.real, np.float64) + 1j * np.asarray(res.imag)
    key = {"LM": -np.abs(lam), "LR": -lam.real}[which]
    order = np.lexsort((lam.imag, key), axis=-1)
    return np.take_along_axis(lam, order, axis=1)


def _true_resid(a, res):
    lam = np.asarray(res.real, np.float64) + 1j * np.asarray(res.imag)
    V = np.asarray(res.vectors_real, np.float64) + 1j * np.asarray(
        res.vectors_imag)
    Av = np.einsum("bij,bjk->bik", a.astype(np.float64), V)
    return np.linalg.norm(Av - lam[:, None, :] * V, axis=1)


def _rotation_spectrum(B, n, seed):
    rng = np.random.RandomState(seed)
    blocks = np.zeros((B, n, n))
    for b in range(B):
        for (i, r, th) in ((0, 12.0, 0.4 + 0.1 * b), (2, 9.0, 1.1)):
            c, s = np.cos(th), np.sin(th)
            blocks[b, i:i + 2, i:i + 2] = r * np.array([[c, -s], [s, c]])
        blocks[b, 4:, 4:] = np.diag(rng.rand(n - 4) * 5)
    P = rng.randn(B, n, n) * 0.5 + np.eye(n)
    return np.einsum("bij,bjk,bkl->bil", P, blocks,
                     np.linalg.inv(P)).astype(np.float32)


def _symmetric(B, n, seed):
    rng = np.random.RandomState(seed)
    lams = np.sort(rng.rand(B, n) * 10, axis=1)[:, ::-1].copy()
    lams[:, :4] += np.asarray([8.0, 6.0, 4.0, 2.0])
    Q, _ = np.linalg.qr(rng.randn(B, n, n))
    return np.einsum("bij,bj,bkj->bik", Q, lams, Q).astype(np.float32)


@pytest.mark.parametrize("case", ["symmetric", "complex", "breakdown"])
def test_arnoldi_matches_jax(case):
    B, k, which = 2, 4, "LM"
    if case == "symmetric":
        a = _symmetric(B, N, 0)
    elif case == "complex":
        a = _rotation_spectrum(B, N, 1)
    else:
        lams = np.linspace(1.0, 20.0, N)[::-1]
        a = np.broadcast_to(np.diag(lams), (B, N, N)).astype(np.float32)
        k, which = 2, "LR"
    v0 = _v0(B, N)
    if case == "breakdown":
        v0[:, 3:] = 0.0          # e0, e1, e2 span an invariant subspace
    m = max(2 * k + 2, 16)
    rt = arnoldi.eigs_arnoldi_batched(
        torch.from_numpy(a), k, which=which, max_restarts=40,
        v0=torch.from_numpy(v0), splice=_jax_splice(B, N, m))
    rj = ja.eigs_arnoldi_batched(jnp.asarray(a), k, which=which,
                                 max_restarts=40, v0=jnp.asarray(v0))
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    assert bool(rt.converged.all())
    scale = np.abs(_sorted(rj, which)).max()
    assert np.abs(_sorted(rt, which) - _sorted(rj, which)).max() \
        <= 1e-4 * scale
    assert (np.asarray(rt.imag)[:, 0] >= 0).all()
    assert _true_resid(a, rt).max() <= 1e-3 * scale
    assert float(rt.resid.max()) <= 200 * np.finfo(np.float32).eps
    assert abs(rt.restarts - rj.restarts) <= 1
    if case == "breakdown":
        np.testing.assert_allclose(np.sort(rt.real.numpy(), axis=1),
                                   [[20.0 - 19.0 / 63, 20.0]] * 2,
                                   atol=1e-3 * 20)


def test_shift_invert_matches_jax():
    """Interior eigenvalues nearest σ = 1.234 of a symmetric spectrum in
    [-10, 10], through ``ops.lu``'s factors."""
    rng = np.random.RandomState(8)
    B, n, k, sigma = 2, N, 4, 1.234
    lams = np.sort(rng.rand(B, n) * 20 - 10, axis=1)
    Q, _ = np.linalg.qr(rng.randn(B, n, n))
    a = np.einsum("bij,bj,bkj->bik", Q, lams, Q).astype(np.float32)
    v0 = _v0(B, n)
    rt = arnoldi.eigs_arnoldi_shifted_batched(
        torch.from_numpy(a), k, sigma, max_restarts=40,
        v0=torch.from_numpy(v0), splice=_jax_splice(B, n, 16))
    rj = ja.eigs_arnoldi_shifted_batched(jnp.asarray(a), k, sigma,
                                         max_restarts=40,
                                         v0=jnp.asarray(v0))
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    assert bool(rt.converged.all())
    got, gj = np.sort(rt.real.numpy(), 1), np.sort(np.asarray(rj.real), 1)
    assert np.abs(got - gj).max() <= 1e-4
    for b in range(B):
        want = np.sort(lams[b][np.argsort(np.abs(lams[b] - sigma))][:k])
        assert np.abs(got[b] - want).max() <= 1e-3
    with pytest.raises(ValueError, match="basis"):
        arnoldi.eigs_arnoldi_batched(torch.from_numpy(a[:, :5, :5]), 4)
