"""The port's Toeplitz, circulant, Hankel and Vandermonde families
(``linalg_solver_tpu_torch.ops.toeplitz`` / ``ops.structured``) against
the JAX package's on the same numpy inputs.

The FFT products agree to 1e-5 of their largest entry (both complex64
FFTs, in different libraries); the Krylov solves to 1e-4 of the largest
entry with equal ``converged`` flags and ``iters``; the circulant solve's
flags exactly; Björck–Pereyra (the same elementwise recurrences in the
same order) to 1e-5 relative where ``ok``, with equal flags, coincident
and overflowing lanes included."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import structured as js
from linalg_solver_tpu.ops import toeplitz as jt
from linalg_solver_tpu_torch.ops import structured, toeplitz

N = 48


def _toeplitz(B, n, seed, dominance=4.0):
    rng = np.random.RandomState(seed)
    decay = np.exp(-0.5 * np.arange(n))
    c = (rng.randn(B, n) * decay).astype(np.float32)
    r = (rng.randn(B, n) * decay).astype(np.float32)
    c[:, 0] += dominance
    r[:, 0] = c[:, 0]
    return c, r


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_toeplitz_products_and_preconditioner():
    c, r = _toeplitz(3, N, seed=1)
    v = np.random.RandomState(2).randn(3, N).astype(np.float32)
    _close(toeplitz.toeplitz_dense_batched(_t(c), _t(r)),
           jt.toeplitz_dense_batched(jnp.asarray(c), jnp.asarray(r)), 0)
    _close(toeplitz.toeplitz_matvec_batched(_t(c), _t(r), _t(v)),
           jt.toeplitz_matvec_batched(jnp.asarray(c), jnp.asarray(r),
                                      jnp.asarray(v)), 1e-5)
    _close(toeplitz.make_toeplitz_matvec(_t(c), _t(r))(_t(v)),
           jt.make_toeplitz_matvec(jnp.asarray(c), jnp.asarray(r))(
               jnp.asarray(v)), 1e-5)
    _close(toeplitz.strang_precond(_t(c), _t(r))(_t(v)),
           jt.strang_precond(jnp.asarray(c), jnp.asarray(r))(
               jnp.asarray(v)), 1e-5)


@pytest.mark.parametrize("spd", [False, True])
def test_toeplitz_solve_matches_jax(spd):
    """GMRES under Strang's preconditioner; with ``spd`` CG on the
    Kac–Murdock–Szegő matrix (SPD).  Against scipy's Levinson solve in
    float64 as well."""
    from scipy.linalg import solve_toeplitz

    if spd:
        col = (0.5 ** np.arange(N)).astype(np.float32)
        c = r = np.broadcast_to(col, (2, N)).copy()
    else:
        c, r = _toeplitz(2, N, seed=4)
    b = np.random.RandomState(5).randn(2, N).astype(np.float32)
    rt = toeplitz.toeplitz_solve_batched(_t(c), _t(r), _t(b), spd=spd,
                                         tol=1e-6)
    rj = jt.toeplitz_solve_batched(jnp.asarray(c), jnp.asarray(r),
                                   jnp.asarray(b), spd=spd, tol=1e-6)
    assert bool(rt.converged.all())
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    assert int(rt.iters) == int(rj.iters)
    _close(rt.x, rj.x, 1e-4)
    for i in range(2):
        want = solve_toeplitz((c[i].astype(np.float64),
                               r[i].astype(np.float64)), b[i])
        assert np.abs(rt.x[i].numpy() - want).max() <= 1e-4


def test_circulant_matches_jax_and_flags_a_singular_symbol():
    """Lane 1's symbol has a zero mode (its entries sum to 0): flagged by
    both, and its clamped pseudo-solve agrees too."""
    rng = np.random.RandomState(8)
    c = (rng.randn(3, N) * np.exp(-0.3 * np.arange(N))).astype(np.float32)
    c[:, 0] += 3.0
    c[1] -= c[1].mean()
    b = rng.randn(3, N).astype(np.float32)
    _close(structured.circulant_dense_batched(_t(c)),
           js.circulant_dense_batched(jnp.asarray(c)), 0)
    _close(structured.circulant_matvec_batched(_t(c), _t(b)),
           js.circulant_matvec_batched(jnp.asarray(c), jnp.asarray(b)), 1e-5)
    rt = structured.circulant_solve_batched(_t(c), _t(b))
    rj = js.circulant_solve_batched(jnp.asarray(c), jnp.asarray(b))
    assert rt.ok.tolist() == np.asarray(rj.ok).tolist() == [True, False,
                                                            True]
    for i in range(3):
        _close(rt.x[i], np.asarray(rj.x)[i], 1e-4)
    C = np.asarray(js.circulant_dense_batched(jnp.asarray(c)), np.float64)
    r0 = C[0] @ rt.x[0].numpy() - b[0]
    assert np.abs(r0).max() <= 1e-5 * np.abs(b[0]).max() * N


def test_hankel_matches_jax():
    rng = np.random.RandomState(9)
    h = (rng.randn(2, 2 * N - 1) * 0.1).astype(np.float32)
    h[:, N - 1] += 4.0            # the anti-diagonal dominates
    c, r = h[:, :N].copy(), h[:, N - 1:].copy()
    v = rng.randn(2, N).astype(np.float32)
    _close(structured.hankel_dense_batched(_t(c), _t(r)),
           js.hankel_dense_batched(jnp.asarray(c), jnp.asarray(r)), 0)
    _close(structured.hankel_matvec_batched(_t(c), _t(r), _t(v)),
           js.hankel_matvec_batched(jnp.asarray(c), jnp.asarray(r),
                                    jnp.asarray(v)), 1e-5)
    rt = structured.hankel_solve_batched(_t(c), _t(r), _t(v), tol=1e-6)
    rj = js.hankel_solve_batched(jnp.asarray(c), jnp.asarray(r),
                                 jnp.asarray(v), tol=1e-6)
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    assert bool(rt.converged.all()) and int(rt.iters) == int(rj.iters)
    _close(rt.x, rj.x, 1e-4)


def _nodes(B, n, seed):
    rng = np.random.RandomState(seed)
    base = np.cos(np.pi * (np.arange(n) + 0.5) / n)
    return np.sort(base[None, :] + 0.05 * rng.randn(B, n) / n,
                   axis=1).astype(np.float32)


@pytest.mark.parametrize("dual", [False, True])
def test_vandermonde_matches_jax(dual):
    """n = 12, lane 1 with a repeated node (flagged), and n = 128 (f32
    overflow: flagged on both)."""
    solve = structured.vandermonde_solve_t_batched if dual else \
        structured.vandermonde_solve_batched
    jsolve = js.vandermonde_solve_t_batched if dual else \
        js.vandermonde_solve_batched
    x = _nodes(3, 12, seed=12)
    x[1, 4] = x[1, 3]
    f = np.random.RandomState(13).randn(3, 12).astype(np.float32)
    _close(structured.vandermonde_dense_batched(_t(x)),
           js.vandermonde_dense_batched(jnp.asarray(x)), 1e-6)
    rt = solve(_t(x), _t(f))
    rj = jsolve(jnp.asarray(x), jnp.asarray(f))
    assert rt.ok.tolist() == np.asarray(rj.ok).tolist() == [True, False,
                                                            True]
    for i in (0, 2):
        _close(rt.x[i], np.asarray(rj.x)[i], 1e-5)
    V = np.vander(x[0].astype(np.float64), increasing=True)
    want = np.linalg.solve(V.T if dual else V, f[0])
    assert np.abs(rt.x[0].numpy() - want).max() <= 1e-3 * np.abs(want).max()
    xb = _nodes(1, 128, seed=30)
    fb = np.random.RandomState(31).randn(1, 128).astype(np.float32)
    assert not bool(solve(_t(xb), _t(fb)).ok[0])
    assert not bool(np.asarray(jsolve(jnp.asarray(xb), jnp.asarray(fb)).ok)[0])
