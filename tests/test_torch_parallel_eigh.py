"""The port's block-Jacobi eigh and one-sided Jacobi SVD over a ring of
ranks against the JAX package (``parallel/distributed_eigh``).

The JAX side runs here on conftest's 8 virtual CPU devices at the JAX
tests' shapes (``tests/test_distributed_eigh.py``,
``test_comm_volume.py``); the port's in a module-scoped pool of 8 gloo
ranks (``torch_parallel_worker``).  ``V`` and ``U`` come back a block of
columns a rank.  Tolerances: eigenvalues and singular values (sorted) to
1e-5 relative with equal ``sweeps_used`` and ``converged``; the comm
meter equal to ``model_eigh_adaptive`` at the sweeps run (the JAX meter,
tracing the sweep loop once, to the same model at one sweep)."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from linalg_solver_tpu.parallel import comm as jcomm
from linalg_solver_tpu.parallel.mesh import make_mesh as jmake_mesh

import torch_parallel_worker as W

# the module (the package's name of the same spelling is its function)
jeig = importlib.import_module("linalg_solver_tpu.parallel.distributed_eigh")

EIG = "parallel.distributed_eigh."


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(W.WORLD)
    yield p
    p.close()


def sym(n, seed=0, spectrum=None):
    rng = np.random.RandomState(seed)
    if spectrum is None:
        a = rng.randn(n, n)
        return ((a + a.T) / 2).astype(np.float32)
    Q, _ = np.linalg.qr(rng.randn(n, n))
    return ((Q * spectrum) @ Q.T).astype(np.float32)


def _hold_eigh(A, got, want, slack=0):
    """Sorted eigenvalues to 1e-5 relative of ‖A‖, the same flag and
    sweeps (``slack`` sweeps apart at most); the port's V orthonormal with
    A V = V diag(w)."""
    scale = max(np.abs(A).max(), 1.0)
    w = got[0]["out"]["w"]
    np.testing.assert_allclose(np.sort(w), np.sort(np.asarray(want.w)),
                               rtol=1e-5, atol=1e-5 * scale)
    for r in got:
        o = r["out"]
        assert abs(int(o["sweeps_used"]) - int(want.sweeps_used)) <= slack
        assert bool(o["converged"]) == bool(want.converged)
        np.testing.assert_array_equal(o["w"], w)
    V = W.collect(got, "dp", dim=1, field="V").astype(np.float64)
    n = A.shape[0]
    np.testing.assert_allclose(V.T @ V, np.eye(n), atol=1e-4)
    assert np.abs(A @ V - V * w[None, :]).max() < 1e-4 * scale


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_eigh_matches_jax(pool, shards):
    A = sym(48, seed=1)
    want = jeig.distributed_eigh(jnp.asarray(A),
                                 jmake_mesh(dp=shards, tp=8 // shards),
                                 axis="dp")
    got = pool.run("call", EIG + "distributed_eigh", shards, 8 // shards,
                   [A, W.MESH], {"axis": "dp"})
    assert bool(want.converged)
    _hold_eigh(A, got, want)


def test_eigh_meter_equals_model_at_the_sweeps_run(pool):
    for D, sweeps in ((2, 6), (4, 8)):
        n = 8 * (2 * D)
        g = np.random.RandomState(3).randn(n, n).astype(np.float32)
        a = (g + g.T) / 2
        jm = Mesh(np.array(jax.devices()[:D]), ("tp",))
        jax.clear_caches()
        with jcomm.CommMeter() as m:
            want = jeig.distributed_eigh(jnp.asarray(a), jm, axis="tp",
                                         sweeps=sweeps)
            jax.block_until_ready(want.w)
        w = n // (2 * D)
        assert {"calls": dict(m.calls), "bytes": dict(m.bytes)} == \
            jcomm.model_eigh_adaptive(n, D, w, 1)
        got = pool.run("call", EIG + "distributed_eigh", 1, D, [a, W.MESH],
                       {"axis": "tp", "sweeps": sweeps}, meter=True)
        k = int(want.sweeps_used)
        assert 1 <= k <= sweeps
        for r in got[:D]:
            assert int(r["out"]["sweeps_used"]) == k
            assert r["meter"] == jcomm.model_eigh_adaptive(n, D, w, k)
            np.testing.assert_allclose(np.sort(r["out"]["w"]),
                                       np.sort(np.asarray(want.w)),
                                       rtol=1e-5, atol=1e-5 * np.abs(a).max())


def test_eigh_early_exit_like_jax(pool):
    """A near-diagonal input stops after fewer sweeps than a Gaussian one,
    at the JAX package's counts."""
    D, n = 4, 64
    rng = np.random.RandomState(7)
    easy = np.diag(np.arange(1, n + 1).astype(np.float32))
    g = rng.randn(n, n).astype(np.float32)
    easy += 1e-6 * (g + g.T) / 2
    g = np.random.RandomState(3).randn(n, n).astype(np.float32)
    hard = (g + g.T) / 2
    jm = Mesh(np.array(jax.devices()[:D]), ("tp",))
    counts = []
    for a in (easy, hard):
        want = int(jeig.distributed_eigh(jnp.asarray(a), jm, axis="tp",
                                         sweeps=8).sweeps_used)
        got = pool.run("call", EIG + "distributed_eigh", 1, D, [a, W.MESH],
                       {"axis": "tp", "sweeps": 8})
        assert int(got[0]["out"]["sweeps_used"]) == want
        counts.append(want)
    assert counts[0] <= 2 and counts[0] < counts[1]


def test_clustered_and_graded_spectra_match_jax(pool):
    """Eigenvectors these spectra do not determine in float32 (a repeated
    eigenvalue's eigenspace; the graded spectrum's eigenvalues below
    eps·‖A‖) take rotations that follow each eigensolver's rounding, and
    with them the sweep at which the off-mass crosses tol = 1e-5: the
    clustered spectrum (1, 2, 3, sixteen times each) is at 8.0e-6 after 7
    sweeps in the JAX package and 1.9e-5 here (3.7e-6 after 8); the
    graded one (1e-3 … 1e3) at 1.007e-5 after 8 sweeps there and 7.8e-6
    here.  Their sweeps are held one apart, the Gaussian inputs' above
    exactly."""
    spec = np.repeat([1.0, 2.0, 3.0], 16)
    A = sym(48, seed=3, spectrum=spec)
    want = jeig.distributed_eigh(jnp.asarray(A), jmake_mesh(dp=4, tp=2),
                                 axis="dp")
    got = pool.run("call", EIG + "distributed_eigh", 4, 2, [A, W.MESH],
                   {"axis": "dp"})
    _hold_eigh(A, got, want, slack=1)
    spec = np.logspace(-3, 3, 64)
    A = sym(64, seed=4, spectrum=spec)
    want = jeig.distributed_eigh(jnp.asarray(A), jmake_mesh(dp=8, tp=1),
                                 axis="dp", sweeps=10)
    got = pool.run("call", EIG + "distributed_eigh", 8, 1, [A, W.MESH],
                   {"axis": "dp", "sweeps": 10})
    _hold_eigh(A, got, want, slack=1)


def test_indivisible_width_raises_like_jax(pool):
    A = sym(30, seed=5)
    for name in ("distributed_eigh", "distributed_svd_jacobi"):
        with pytest.raises(ValueError) as e:
            getattr(jeig, name)(jnp.asarray(A), jmake_mesh(dp=4, tp=2),
                                axis="dp")
        got = pool.run("raises", EIG + name, 4, 2, [A, W.MESH, "dp"])
        assert got[0] == ("ValueError", str(e.value))


def _hold_svd(A, got, want):
    s = got[0]["out"]["s"]
    np.testing.assert_allclose(np.sort(s), np.sort(np.asarray(want.s)),
                               rtol=1e-5, atol=1e-5 * s.max())
    for r in got[:8]:
        if r is None:
            continue
        assert int(r["out"]["sweeps_used"]) == int(want.sweeps_used)
        assert bool(r["out"]["converged"]) == bool(want.converged)
    U = W.collect(got, "dp", dim=1, field="U").astype(np.float64)
    V = W.collect(got, "dp", dim=1, field="V").astype(np.float64)
    np.testing.assert_allclose((U * s[None, :]) @ V.T, A,
                               atol=1e-4 * np.abs(A).max())
    np.testing.assert_allclose(V.T @ V, np.eye(V.shape[1]), atol=1e-4)


@pytest.mark.parametrize("shards", [1, 4])
def test_svd_jacobi_matches_jax(pool, shards):
    A = np.random.RandomState(7).randn(40, 32).astype(np.float32)
    want = jeig.distributed_svd_jacobi(
        jnp.asarray(A), jmake_mesh(dp=shards, tp=8 // shards), axis="dp")
    got = pool.run("call", EIG + "distributed_svd_jacobi", shards,
                   8 // shards, [A, W.MESH], {"axis": "dp"})
    assert bool(want.converged)
    _hold_svd(A, got, want)


def test_svd_jacobi_rank_deficient_and_spd_like_jax(pool):
    rng = np.random.RandomState(8)
    A = (rng.randn(24, 8) @ rng.randn(8, 16)).astype(np.float32)
    mesh = jmake_mesh(dp=4, tp=2)
    want = jeig.distributed_svd_jacobi(jnp.asarray(A), mesh, axis="dp",
                                       sweeps=12)
    got = pool.run("call", EIG + "distributed_svd_jacobi", 4, 2,
                   [A, W.MESH], {"axis": "dp", "sweeps": 12})
    s = np.sort(got[0]["out"]["s"])[::-1]
    np.testing.assert_allclose(s, np.sort(np.asarray(want.s))[::-1],
                               atol=1e-5 * s[0])
    assert (s[8:] < 1e-3 * s[0]).all()
    assert int(got[0]["out"]["sweeps_used"]) == int(want.sweeps_used)
    A = sym(32, seed=9, spectrum=np.linspace(1.0, 50.0, 32))
    mesh = jmake_mesh(dp=2, tp=4)
    want = jeig.distributed_svd_jacobi(jnp.asarray(A), mesh, axis="dp")
    got = pool.run("call", EIG + "distributed_svd_jacobi", 2, 4,
                   [A, W.MESH], {"axis": "dp"})
    _hold_svd(A, got, want)
    np.testing.assert_allclose(np.sort(got[0]["out"]["s"]),
                               np.linspace(1.0, 50.0, 32), rtol=1e-4)
