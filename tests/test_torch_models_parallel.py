"""The port's batch-sharded ``BatchedSolver``, preconditioner training
step, sharded spectral pipeline and ``dryrun_multichip`` against the JAX
package (``models/solver``, ``models/spectral``, ``graft_entry``).

The JAX side runs here on conftest's 8 virtual CPU devices at the JAX
tests' shapes (``tests/test_models_parallel.py``); the port's in a
module-scoped pool of 8 gloo ranks (``torch_parallel_worker``).
Tolerances: the sharded batch ops bitwise equal to the port's unsharded
ones with an empty comm meter, and to the JAX package's values at
float32 rounding; the training step at tp = 1 equal to the JAX step, at
every layout equal to the float64 exact step (the JAX step at tp > 1 is
tp times too long, which the tests record)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from linalg_solver_tpu.models import solver as jsolver
from linalg_solver_tpu.models.spectral import (
    spectral_pipeline as jspectral_pipeline,
    spectral_pipeline_sharded as jspectral_sharded,
)
from linalg_solver_tpu.ops.generate import diagonalizable_batch
from linalg_solver_tpu.parallel.mesh import make_mesh as jmake_mesh
from linalg_solver_tpu.parallel.mesh import replicate, shard_batch

import torch_parallel_worker as W


@pytest.fixture(scope="module")
def pool():
    p = W.Pool(W.WORLD)
    yield p
    p.close()


def _batch(B=16, N=64, seed=0):
    rng = np.random.RandomState(seed)
    a = (rng.randn(B, N, N) + 4.0 * N ** 0.5 * np.eye(N)).astype(np.float32)
    return a, rng.randn(B, N).astype(np.float32)


def test_batch_shard_axes_and_refusals_match_jax(pool):
    jm = jmake_mesh(dp=4, tp=2)
    got = pool.run("call", "models.solver.batch_shard_axes", 4, 2,
                   [W.MESH, 16])
    assert got[0]["out"] == jsolver.batch_shard_axes(jm, 16) == ("dp", "tp")
    got = pool.run("call", "models.solver.batch_shard_axes", 4, 2,
                   [W.MESH, 4])
    assert got[0]["out"] == jsolver.batch_shard_axes(jm, 4) == ("dp",)
    with pytest.raises(ValueError) as e:
        jsolver.batch_shard_axes(jm, 6)
    got = pool.run("raises", "models.solver.batch_shard_axes", 4, 2,
                   [W.MESH, 6])
    assert got[0] == ("ValueError", str(e.value))
    with pytest.raises(ValueError, match="not divisible") as e:
        jspectral_sharded(jnp.zeros((6, 3, 3)), jm)
    got = pool.run("raises", "models.spectral.spectral_pipeline_sharded",
                   4, 2, [np.zeros((6, 3, 3), np.float32), W.MESH])
    assert got[0] == ("ValueError", str(e.value))


def test_replicate_gives_every_rank_the_first_ranks_tensor(pool):
    """``replicate`` broadcasts the mesh's first rank's tensor (each rank
    passes its own here), the array JAX's ``replicate`` places on every
    device; a (2, 2) mesh leaves ranks 4-7 out."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    jm = jmake_mesh(dp=4, tp=2)
    for shard_ in replicate(jnp.asarray(x), jm).addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard_.data), x)
    for dp, tp in ((4, 2), (2, 2)):
        got = pool.run("replicate_ranks", dp, tp, x)
        for r in got[:dp * tp]:
            np.testing.assert_array_equal(r, x)
        assert all(r is None for r in got[dp * tp:])


@pytest.mark.parametrize("backend", ["auto", "rbt"])
def test_sharded_solve_is_bitwise_with_zero_collectives(pool, backend):
    """Lanes are independent: each rank's solve is bitwise the unsharded
    call's rows, with an empty meter, vector and matrix right-hand
    sides; the values agree with the JAX package's sharded solve."""
    a, b = _batch(seed=7)
    jm = jmake_mesh(dp=4, tp=2)
    want = np.asarray(jsolver.BatchedSolver(mesh=jm, backend=backend).solve(
        shard_batch(jnp.asarray(a), jm), shard_batch(jnp.asarray(b), jm)))
    got = pool.run("batch_ops", 4, 2, ["solve"], a, b, backend)
    for (r, w) in zip(got, np.split(want, 8)):
        x, x_ref, meter = r["solve"]
        np.testing.assert_array_equal(x, x_ref)
        assert meter == {"calls": {}, "bytes": {}}
        np.testing.assert_allclose(x, w, atol=1e-5)
    if backend == "auto":
        B3 = np.random.RandomState(8).randn(16, 64, 3).astype(np.float32)
        got = pool.run("batch_ops", 4, 2, ["solve"], a, B3, backend)
        for r in got:
            x, x_ref, meter = r["solve"]
            np.testing.assert_array_equal(x, x_ref)
            assert meter == {"calls": {}, "bytes": {}} and x.shape == (2, 64, 3)


def test_sharded_inverse_det_rank_bitwise_and_match_jax(pool):
    rng = np.random.RandomState(5)
    a = (rng.randn(16, 8, 8) + 3.0 * np.eye(8)).astype(np.float32)
    jm = jmake_mesh(dp=4, tp=2)
    jsv = jsolver.BatchedSolver(mesh=jm)
    a_sh = shard_batch(jnp.asarray(a), jm)
    want = {"inverse": np.asarray(jsv.inverse(a_sh)),
            "det": np.asarray(jsv.det(a_sh)),
            "rank": np.asarray(jsv.rank(a_sh))}
    got = pool.run("batch_ops", 4, 2, ["inverse", "det", "rank"], a)
    for op, w in want.items():
        for r, ws in zip(got, np.split(w, 8)):
            x, x_ref, meter = r[op]
            np.testing.assert_array_equal(x, x_ref)
            assert meter == {"calls": {}, "bytes": {}}
            if op == "rank":
                np.testing.assert_array_equal(x, ws)
            else:
                np.testing.assert_allclose(x, ws, rtol=1e-5, atol=1e-6)


def _train_inputs():
    k_a, k_b = jax.random.split(jax.random.PRNGKey(3))
    a = jax.random.normal(k_a, (8, 8, 8)) + 3.0 * jnp.eye(8)
    b = jax.random.normal(k_b, (8, 8))
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


def _jax_step(tp, a, b, lr=1e-2):
    mesh = jmake_mesh(tp=tp)
    state = jsolver.init_train_state(8)
    state = type(state)(replicate(state.params, mesh), state.step)
    with mesh:
        new, loss = jsolver.make_training_step(mesh, lr=lr)(
            state, shard_batch(jnp.asarray(a), mesh),
            shard_batch(jnp.asarray(b), mesh))
    return np.asarray(new.params), float(loss)


def _exact_step(a, b, lr=1e-2):
    """M₀ − lr·∇L in float64 from M₀ = I, with ∇L = mean_b A_bᵀ r_b b_bᵀ,
    r_b = A_b M₀ b_b − b_b, the gradient of L = ½ mean_b ‖r_b‖²."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    r = np.einsum("bij,bj->bi", a, b) - b
    grad = np.einsum("bji,bj,bk->ik", a, r, b) / a.shape[0]
    return np.eye(8) - lr * grad, 0.5 * np.mean(np.sum(r * r, axis=1))


def test_training_step_at_tp1_equals_jax(pool):
    a, b = _train_inputs()
    want, loss = _jax_step(1, a, b)
    got = pool.run("train", 8, 1, np.eye(8, dtype=np.float32), a, b, 1e-2)
    for params, losses, step in got:
        np.testing.assert_allclose(params, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(losses[0], loss, rtol=1e-6)
        assert step == 1


@pytest.mark.parametrize("tp", [2, 4])
def test_training_step_is_layout_invariant_where_jax_is_tp_times_long(
        pool, tp):
    """The port's step at tp > 1 equals its tp = 1 step and the float64
    exact step; the JAX package's displacement is tp times the exact one
    (the transpose of its loss's psum sums a cotangent that every tp
    shard already holds whole), at the loss it reports correctly."""
    a, b = _train_inputs()
    exact, loss64 = _exact_step(a, b)
    eye = np.eye(8, dtype=np.float32)
    one = pool.run("train", 8, 1, eye, a, b, 1e-2)[0][0]
    got = pool.run("train", 8 // tp, tp, eye, a, b, 1e-2)
    d_exact = exact - np.eye(8)
    for params, losses, _ in got:
        np.testing.assert_allclose(params, one, rtol=1e-6, atol=1e-6)
        assert np.abs(params - exact).max() <= 1e-5 * np.abs(d_exact).max()
        np.testing.assert_allclose(losses[0], loss64, rtol=1e-5)
    jparams, jloss = _jax_step(tp, a, b)
    d_jax = jparams.astype(np.float64) - np.eye(8)
    np.testing.assert_allclose(d_jax, tp * d_exact,
                               atol=1e-4 * np.abs(tp * d_exact).max())
    np.testing.assert_allclose(jloss, loss64, rtol=1e-5)


def test_training_loss_decreases_on_mesh(pool):
    rng = np.random.RandomState(0)
    a = (rng.randn(8, 8, 8) + 3.0 * np.eye(8)).astype(np.float32)
    b = rng.randn(8, 8).astype(np.float32)
    got = pool.run("train", 4, 2, np.eye(8, dtype=np.float32), a, b, 1e-2,
                   steps=2)
    for params, losses, step in got:
        assert step == 2 and losses[1] < losses[0]
        np.testing.assert_array_equal(params, got[0][0])


def test_sharded_spectral_is_the_unsharded_pipeline_on_each_slice(pool):
    """Each rank's report is bitwise the unsharded pipeline's on its dp
    slice, with no collective; eigenvalues and multiplicities agree with
    the JAX package's pipeline on the whole batch."""
    A = np.asarray(diagonalizable_batch(
        jax.random.PRNGKey(0), 8, [4.0, 1.0, 1.0, -2.0],
        transform="orthogonal"), np.float32)
    want = jspectral_pipeline(jnp.asarray(A), tol=1e-2)
    got = pool.run("spectral_sharded", 4, 2, A, 1e-2)
    for r in got:
        assert r["meter"] == {"calls": {}, "bytes": {}}
        for f, v in r["out"].items():
            np.testing.assert_array_equal(v, r["ref"][f], err_msg=f)
        i = r["coord"][0]
        sl = slice(2 * i, 2 * i + 2)
        assert r["out"]["diagonalizable"].all()
        np.testing.assert_allclose(r["out"]["eig_real"],
                                   np.asarray(want.eig_real)[sl], atol=1e-5)
        for f in ("alg_mult", "geom_mult"):
            np.testing.assert_array_equal(r["out"][f],
                                          np.asarray(getattr(want, f))[sl])
        rec = (r["out"]["P"].astype(np.float64) @ r["out"]["D"]
               @ r["out"]["P_inv"])
        assert np.abs(rec - A[sl]).max() < 1e-3


def test_dryrun_multichip_on_eight_ranks(pool):
    """The whole mesh sequence on a (4, 2) mesh of 8 ranks; the
    replicated figures are the same on every rank."""
    got = pool.run("dryrun", 8)
    for fig in got:
        for k in ("loss", "dist_lu_resid", "dist_svd_err", "dd_resid",
                  "eigh_sweeps"):
            assert fig[k] == got[0][k], k
    assert 1 <= got[0]["eigh_sweeps"] < 8
    assert got[0]["dist_lu_resid"] < 1e-4 and got[0]["dd_resid"] < 1e-8
