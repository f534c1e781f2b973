"""The port's ``BatchedSolver`` (``linalg_solver_tpu_torch.models.solver``)
against the JAX package's, fed the same numpy inputs: every method on
the ``"loop"`` backend on both sides, the ``"auto"`` routes against the
same, and the serving flow of ``examples/serving_pipeline.py``
(``solve_checked``, then ``affine_solve`` for the systems that failed
the check) with singular systems planted.

Exact: perm, sign, ok, ranks, the check's mask, ``dim`` and
``is_consistent``.  Values: within 1e-5 relative on ``"loop"`` (the same
operations), and on ``"auto"`` a float64 residual ≤ 1e-5 (other
algorithms: the fused RBT solve and inverse, kernel 3's det)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.models.solver import BatchedSolver as JSolver
from linalg_solver_tpu_torch.models.solver import BatchedSolver

RTOL = 1e-5
N = 12


def _batch(seed, bsz=3, n=N):
    rng = np.random.RandomState(seed)
    a = (rng.randn(bsz, n, n) + 2 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)
    return a, rng.randn(bsz, n).astype(np.float32)


def _close(x, y, rtol=RTOL):
    x, y = np.asarray(x), np.asarray(y)
    assert x.shape == y.shape
    assert np.abs(x - y).max() <= rtol * max(np.abs(y).max(), 1.0)


def test_loop_methods_match_jax():
    a, b = _batch(31)
    a[2, 5] = a[2, 1]                       # singular: rank 11
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    ts, js = BatchedSolver(backend="loop"), JSolver(backend="loop")
    _close(ts.solve(at[:2], bt[:2]), js.solve(aj[:2], bj[:2]))
    _close(ts.inverse(at[:2]), js.inverse(aj[:2]))
    _close(ts.det(at), js.det(aj))
    assert ts.rank(at).tolist() == np.asarray(js.rank(aj)).tolist() \
        == [12, 12, 11]
    ft, fj = ts.factor(at), js.factor(aj)
    for f in ("perm", "sign", "ok"):
        np.testing.assert_array_equal(getattr(ft, f).numpy(),
                                      np.asarray(getattr(fj, f)))
    _close(ft.lu, fj.lu)
    st, sj = ts.affine_solve(at, bt), js.affine_solve(aj, bj)
    for f in ("dim", "gen_mask", "is_consistent"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    _close(st.particular, sj.particular)
    _close(st.generators, sj.generators)


def test_auto_methods_solve_their_systems():
    """``"auto"``: the fused solve and inverse (plain versions here),
    kernel 3's det, rank and affine solve; results hold against float64
    and against the JAX solver's ``"loop"`` ranks and solution sets."""
    a, b = _batch(32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    ts, js = BatchedSolver(), JSolver(backend="loop")
    a64 = a.astype(np.float64)
    x = ts.solve(at, bt).numpy().astype(np.float64)
    assert np.abs(np.einsum("bij,bj->bi", a64, x) - b).max() <= 1e-5 * \
        np.abs(b).max()
    xi = ts.inverse(at).numpy().astype(np.float64)
    assert np.abs(a64 @ xi - np.eye(N)).max() <= 5e-5
    np.testing.assert_allclose(ts.det(at).numpy(), np.linalg.det(a64),
                               rtol=1e-4)
    assert ts.rank(at).tolist() == np.asarray(
        js.rank(jnp.asarray(a))).tolist()
    st = ts.affine_solve(at, bt)
    sj = js.affine_solve(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(st.dim.numpy(), np.asarray(sj.dim))
    _close(st.particular, sj.particular, rtol=1e-4)


def test_serving_flow_retries_only_the_planted_systems():
    """Integer systems in [-5, 5) with two singular ones planted: lane 2
    repeats a row with b off the range (no solution), lane 5 is zero with
    b = 0 (every x solves it, and no square solver returns one).
    ``solve_checked`` fails those two and only those, as the JAX
    solver's does; their retry through ``affine_solve`` tells them apart
    as the JAX one does.  (A consistent singular system may pass the
    check: its refined solve can be a solution.)"""
    rng = np.random.RandomState(33)
    a = rng.randint(-5, 5, size=(8, 10, 10)).astype(np.float32)
    b = rng.randint(-5, 5, size=(8, 10)).astype(np.float32)
    a[2, 7] = a[2, 3]
    b[2, 7] = b[2, 3] + 1.0
    a[5], b[5] = 0.0, 0.0
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    x, rel, ok = BatchedSolver().solve_checked(at, bt)
    _, relj, okj = JSolver(backend="loop").solve_checked(jnp.asarray(a),
                                                         jnp.asarray(b))
    assert (~ok).nonzero().flatten().tolist() == [2, 5]
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert x.shape == bt.shape and rel.shape == (8,)
    assert float(rel[ok].max()) <= 1e-5
    bad = ~ok
    sub = BatchedSolver().affine_solve(at[bad], bt[bad])
    subj = JSolver(backend="loop").affine_solve(
        jnp.asarray(a[bad.numpy()]), jnp.asarray(b[bad.numpy()]))
    assert sub.is_consistent.tolist() == [False, True]
    assert sub.dim.tolist() == [1, 10]
    np.testing.assert_array_equal(sub.is_consistent.numpy(),
                                  np.asarray(subj.is_consistent))
    np.testing.assert_array_equal(sub.dim.numpy(), np.asarray(subj.dim))


def _serving_input(method):
    rng = np.random.RandomState(41)
    if method == "lstsq":
        a = rng.randn(3, 10, 4).astype(np.float32)
        a[1, :, 2] = 0.0              # rank-deficient: not ok, NaN
        return a, rng.randn(3, 10).astype(np.float32)
    if method == "det_exact":
        a = rng.randint(-5, 5, size=(8, 8, 8)).astype(np.int32)
        a[2, 4] = a[2, 1]             # singular
        a[5] *= 2000                  # overflows int32: not ok
        return (a,)
    a = rng.randn(4, N, N).astype(np.float32)
    if method == "rcond":
        a[3, 5] = a[3, 2]             # singular: 0
    return (a,)


@pytest.mark.parametrize("method", ["lstsq", "svd", "rcond", "det_exact"])
def test_serving_methods_match_jax(method):
    """``lstsq``, ``svd``, ``rcond`` and ``det_exact`` against the JAX
    ``BatchedSolver``'s on the same input: flags and integers exactly,
    values within 1e-5 (singular vectors after aligning their signs)."""
    args = _serving_input(method)
    want = getattr(JSolver(), method)(*map(jnp.asarray, args))
    got = getattr(BatchedSolver(), method)(*map(torch.from_numpy, args))
    if method == "rcond":
        _close(got, want)
        assert got[3] == 0 and bool((got[:3] > 0).all())
        return
    for f in got._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "ok" or method == "det_exact":
            np.testing.assert_array_equal(g, w)
        elif method == "svd" and f in ("U", "V"):
            sg = np.sign((got.U.numpy() * np.asarray(want.U)).sum(axis=1))
            _close(g * sg[:, None, :], w)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            _close(np.nan_to_num(g), np.nan_to_num(w))
    if method == "lstsq":
        assert got.ok.tolist() == [True, False, True]
    if method == "det_exact":
        assert not bool(got.ok[5]) and int(got.rank[2]) == 7


def test_mesh_raises_and_names_its_item():
    """A mesh is a ``DeviceMesh`` (``parallel.mesh.make_mesh``); anything
    else is refused by name (the sharded methods are held against the JAX
    package in ``test_torch_models_parallel.py``)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        BatchedSolver(mesh=object())
