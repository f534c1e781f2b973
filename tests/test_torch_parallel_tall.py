"""The port's row-sharded tall factorizations and Krylov solves against
the JAX package (``parallel/distributed_tall``, ``distributed_krylov``).

The JAX side runs here on conftest's 8 virtual CPU devices at the JAX
tests' shapes (``tests/test_distributed_tall.py``,
``test_distributed_krylov.py``); the port's in a module-scoped pool of 8
gloo ranks (``torch_parallel_worker``).  Row-sharded factors come back a
block of rows a rank and are concatenated over dp.  Tolerances: R, x,
singular values and reconstructions to float32 rounding of the problem's
scale (the two packages' Cholesky and eigh round differently), the
Krylov iteration counts and flags equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from linalg_solver_tpu.parallel import distributed_krylov as jkry
from linalg_solver_tpu.parallel import distributed_tall as jtall
from linalg_solver_tpu.parallel.mesh import make_mesh as jmake_mesh

import torch_parallel_worker as W

TALL = "parallel.distributed_tall."
KRY = "parallel.distributed_krylov."


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(W.WORLD)
    yield p
    p.close()


def tall(M, n, seed=0):
    return np.random.RandomState(seed).randn(M, n).astype(np.float32)


def _mesh(shards):
    return jmake_mesh(dp=shards, tp=8 // shards)


def _signs(got, want):
    """Column signs that align ``got`` with ``want`` (singular vectors
    are determined up to sign)."""
    return np.sign((got * want).sum(axis=0))


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_cholqr2_matches_jax(pool, shards):
    A = tall(64, 12, seed=1)
    want = jtall.distributed_cholqr2(jnp.asarray(A), _mesh(shards), axis="dp")
    got = pool.run("call", TALL + "distributed_cholqr2", shards,
                   8 // shards, [A, W.MESH], {"axis": "dp"})
    q = W.collect(got, "dp", field="q")
    for r in got:
        np.testing.assert_allclose(r["out"]["R"], np.asarray(want.R),
                                   atol=2e-5 * np.abs(want.R).max())
        assert bool(r["out"]["ok"]) == bool(want.ok) is True
    np.testing.assert_allclose(q, np.asarray(want.q), atol=2e-5)
    np.testing.assert_allclose(q @ got[0]["out"]["R"], A, atol=1e-4)


@pytest.mark.parametrize("shards", [2, 8])
def test_lstsq_matches_jax(pool, shards):
    A = tall(80, 10, seed=3)
    b = np.random.RandomState(4).randn(80).astype(np.float32)
    want = np.asarray(jtall.distributed_lstsq(jnp.asarray(A), jnp.asarray(b),
                                              _mesh(shards)))
    got = pool.run("call", TALL + "distributed_lstsq", shards, 8 // shards,
                   [A, b, W.MESH])
    for r in got:
        np.testing.assert_allclose(r["out"], want, atol=1e-5)
    if shards == 2:          # a block right-hand side, as the JAX test's
        A = tall(48, 6, seed=5)
        B = np.random.RandomState(6).randn(48, 3).astype(np.float32)
        want = np.asarray(jtall.distributed_lstsq(
            jnp.asarray(A), jnp.asarray(B), jmake_mesh(dp=4, tp=2)))
        got = pool.run("call", TALL + "distributed_lstsq", 4, 2,
                       [A, B, W.MESH])
        np.testing.assert_allclose(got[0]["out"], want, atol=1e-5)


def test_polar_and_svd_tall_match_jax(pool):
    A = tall(64, 10, seed=9)
    want = jtall.distributed_polar_tall(jnp.asarray(A), _mesh(8))
    got = pool.run("call", TALL + "distributed_polar_tall", 8, 1,
                   [A, W.MESH])
    up = W.collect(got, "dp", field="up")
    np.testing.assert_allclose(up, np.asarray(want.up), atol=2e-5)
    np.testing.assert_allclose(got[0]["out"]["H"], np.asarray(want.H),
                               atol=2e-5 * np.abs(want.H).max())
    np.testing.assert_allclose(up @ got[0]["out"]["H"], A, atol=1e-4)
    assert bool(got[0]["out"]["ok"]) == bool(want.ok) is True
    # the SVD on the polar factor, at the JAX test's (2, 4) layout
    A = tall(72, 12, seed=10)
    want = jtall.distributed_svd_tall(jnp.asarray(A), _mesh(2))
    got = pool.run("call", TALL + "distributed_svd_tall", 2, 4, [A, W.MESH])
    s = got[0]["out"]["s"]
    np.testing.assert_allclose(s, np.asarray(want.s), atol=2e-5 * s[0])
    sg = _signs(got[0]["out"]["V"], np.asarray(want.V))
    np.testing.assert_allclose(got[0]["out"]["V"] * sg, np.asarray(want.V),
                               atol=1e-4)
    U = W.collect(got, "dp", field="U")
    np.testing.assert_allclose(U * sg, np.asarray(want.U), atol=1e-4)
    np.testing.assert_allclose((U * s) @ got[0]["out"]["V"].T, A,
                               atol=2e-4 * s[0])


@pytest.mark.parametrize("shards", [2, 8])
def test_randomized_svd_matches_jax_on_its_sketch(pool, shards):
    """The JAX package draws Ω from ``PRNGKey(0)``; the port takes that
    draw as ``omega``."""
    rng = np.random.RandomState(20)
    M, n, r = 64, 24, 4
    A = (rng.randn(M, r) @ rng.randn(r, n)).astype(np.float32)
    want = jtall.distributed_randomized_svd(jnp.asarray(A), _mesh(shards),
                                            k=r)
    omega = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (n, min(r + 8, n)), jnp.float32))
    got = pool.run("call", TALL + "distributed_randomized_svd", shards,
                   8 // shards, [A, W.MESH, r], {"omega": omega})
    o = got[0]["out"]
    np.testing.assert_allclose(o["s"], np.asarray(want.s), rtol=1e-4)
    np.testing.assert_array_equal(o["valid"], np.asarray(want.valid))
    assert bool(o["ok"]) == bool(want.ok) is True
    U = W.collect(got, "dp", field="U")
    sg = _signs(o["V"], np.asarray(want.V))
    np.testing.assert_allclose(o["V"] * sg, np.asarray(want.V), atol=1e-4)
    np.testing.assert_allclose(U * sg, np.asarray(want.U), atol=1e-4)
    np.testing.assert_allclose((U * o["s"]) @ o["V"].T, A,
                               atol=1e-4 * np.abs(A).max())


def spd_system(N, seed=0):
    rng = np.random.RandomState(seed)
    G = rng.randn(N, N)
    A = (G @ G.T / N + 4 * np.eye(N)).astype(np.float32)
    return A, rng.randn(N).astype(np.float32)


def general_system(N, seed=3):
    rng = np.random.RandomState(seed)
    A = (rng.randn(N, N) + 4 * np.sqrt(N) * np.eye(N)).astype(np.float32)
    return A, rng.randn(N).astype(np.float32)


def _hold_krylov(got, want, atol):
    for r in got:
        o = r["out"]
        assert int(o["iters"]) == int(want.iters)
        assert bool(o["converged"]) == bool(want.converged)
        np.testing.assert_allclose(o["x"], np.asarray(want.x), atol=atol)
        np.testing.assert_allclose(o["resnorm"], float(want.resnorm),
                                   rtol=0.5, atol=1e-6)


def test_cg_matches_jax_across_meshes(pool):
    """The same iteration count and solution at every mesh width."""
    A, b = spd_system(128)
    for dp in (1, 2, 8):
        mesh = jmake_mesh(dp=dp, tp=1, devices=jax.devices()[:dp])
        want = jkry.distributed_cg(jnp.asarray(A), jnp.asarray(b), mesh,
                                   tol=1e-6)
        got = pool.run("call", KRY + "distributed_cg", dp, 1, [A, b, W.MESH],
                       {"tol": 1e-6}, meter=True)
        _hold_krylov(got[:dp], want, 1e-6)
        assert all(r is None for r in got[dp:])
        # one all-gather of [N/p] a matvec, one for the Jacobi diagonal
        m = got[0]["meter"]
        assert set(m["calls"]) == {"all_gather"}
        assert m["bytes"]["all_gather"] == m["calls"]["all_gather"] * 4 * (
            128 // dp)


def test_bicgstab_and_gmres_match_jax(pool):
    mesh = jmake_mesh(dp=8, tp=1)
    for name, seed in (("distributed_bicgstab", 3), ("distributed_gmres", 4)):
        A, b = general_system(96, seed)
        want = getattr(jkry, name)(jnp.asarray(A), jnp.asarray(b), mesh,
                                   tol=1e-6)
        got = pool.run("call", KRY + name, 8, 1, [A, b, W.MESH],
                       {"tol": 1e-6})
        _hold_krylov(got, want, 1e-6)
        assert bool(want.converged)


def test_cg_admits_failure_on_indefinite_like_jax(pool):
    rng = np.random.RandomState(2)
    N = 64
    A = np.diag(np.concatenate([np.ones(32), -np.ones(32)])).astype(
        np.float32) + 0.01 * rng.randn(N, N).astype(np.float32)
    A = (A + A.T) / 2
    b = rng.randn(N).astype(np.float32)
    want = jkry.distributed_cg(jnp.asarray(A), jnp.asarray(b),
                               jmake_mesh(dp=8, tp=1), tol=1e-7, max_iters=5)
    got = pool.run("call", KRY + "distributed_cg", 8, 1, [A, b, W.MESH],
                   {"tol": 1e-7, "max_iters": 5})
    assert not bool(want.converged)
    for r in got:
        assert not bool(r["out"]["converged"])
        assert int(r["out"]["iters"]) == int(want.iters) == 5
