"""The port's affine solve, nullspace, Gauss–Jordan inverse, rank and
determinant (``linalg_solver_tpu_torch.ops.solve``) against the JAX
package's ``ops.solve``, fed the same numpy inputs: the loop side
(``solve_batched``, ``nullspace_batched``, ``inverse_batched``,
``rank_batched``, ``det_gj_batched``) and the kernel side
(``augment_square_padded``, ``solve_affine_gj_batched``, whose JAX
version runs the Gauss–Jordan kernel in interpret mode, and the port's
its plain version on the CPU).

Exact: ``dim``, ``gen_mask``, ``is_consistent``, ranks, invertibility.
Values: within 1e-5 of each system's largest entry (the loop and the
kernel run the same f32 operations as the reference and agree to the
bit on finite input; the extraction's gathers are exact where the
reference's one-hot products are).  Systems: consistent and
inconsistent rank-deficient ones, rectangular ones both ways, a zero
matrix."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

tsolve = importlib.import_module("linalg_solver_tpu_torch.ops.solve")

jsolve = importlib.import_module("linalg_solver_tpu.ops.solve")

RTOL = 1e-5
EXACT = ("gen_mask", "dim", "is_consistent")


def _systems(m, n, seed):
    """Four ``[m, n]`` systems: random (full rank), a column that repeats
    another with a consistent b, the same with b off the range
    (inconsistent), and a zero matrix with b = 0."""
    rng = np.random.RandomState(seed)
    a = rng.randn(4, m, n).astype(np.float32)
    a[1:3, :, n - 1] = a[1:3, :, 0]
    b = rng.randn(4, m).astype(np.float32)
    b[1] = a[1] @ rng.randn(n).astype(np.float32)
    if m <= n:   # b off the range needs a rank below m
        a[2, m - 1] = a[2, 0]
        b[2, m - 1] = b[2, 0] + 1.0
    a[3], b[3] = 0.0, 0.0
    return a, b


def _assert_affine(sj, st):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    for f in ("particular", "generators"):
        x, y = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert x.shape == y.shape, f
        for i in range(x.shape[0]):
            assert np.abs(x[i] - y[i]).max() <= RTOL * max(
                np.abs(x[i]).max(), 1.0), (f, i)


@pytest.mark.parametrize("m,n,rule", [(6, 5, "partial"), (4, 6, "first")],
                         ids=["tall_partial", "wide_first"])
def test_solve_batched_matches_jax(m, n, rule):
    a, b = _systems(m, n, seed=m * 10 + n)
    sj = jsolve.solve_batched(jnp.asarray(a), jnp.asarray(b),
                              pivot_rule=rule)
    st = tsolve.solve_batched(torch.from_numpy(a), torch.from_numpy(b),
                              pivot_rule=rule)
    _assert_affine(sj, st)
    assert st.is_consistent.tolist()[2] is False
    assert int(st.dim[3]) == n


def test_per_matrix_tol_matches_jax_vmap():
    """``tol [B]``: the reference's per-matrix loop (``vmap`` of ``solve``
    over (a, b, tol), as its dispatch runs it)."""
    a, b = _systems(6, 5, seed=65)
    tol = np.array([1e-6, 1e-5, 1e-4, 0.0], np.float32)
    sj = jax.vmap(lambda a1, b1, t: jsolve.solve(
        a1, b1, tol=t, pivot_rule="partial"))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(tol))
    st = tsolve.solve_batched(torch.from_numpy(a), torch.from_numpy(b),
                              tol=torch.from_numpy(tol),
                              pivot_rule="partial")
    _assert_affine(sj, st)


def test_nullspace_inverse_rank_det_match_jax():
    a, _ = _systems(5, 5, seed=55)
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    _assert_affine(jsolve.nullspace_batched(aj, pivot_rule="partial"),
                   tsolve.nullspace_batched(at, pivot_rule="partial"))
    ij = jsolve.inverse_batched(aj, tol=1e-30)
    it = tsolve.inverse_batched(at, tol=1e-30)
    np.testing.assert_array_equal(it.is_invertible.numpy(),
                                  np.asarray(ij.is_invertible))
    assert it.is_invertible.tolist() == [True, False, False, False]
    assert np.isnan(it.inverse[1:].numpy()).all()
    x = np.asarray(ij.inverse)[0]
    assert np.abs(it.inverse[0].numpy() - x).max() <= RTOL * np.abs(x).max()
    np.testing.assert_array_equal(tsolve.rank_batched(at).numpy(),
                                  np.asarray(jsolve.rank_batched(aj)))
    assert tsolve.rank_batched(at).tolist() == [5, 4, 4, 0]
    np.testing.assert_allclose(tsolve.det_gj_batched(at).numpy(),
                               np.asarray(jsolve.det_gj_batched(aj)),
                               rtol=RTOL, atol=0)
    one = tsolve.solve(at[1], torch.zeros(5), pivot_rule="partial")
    basis = one.basis_list()
    assert len(basis) == int(one.dim) == 1
    assert float((at[1].double() @ basis[0].double()).abs().max()) <= 1e-5


@pytest.mark.parametrize("m,n", [(6, 5), (4, 6)], ids=["tall", "wide"])
def test_kernel_affine_solve_matches_jax_kernel(m, n):
    """``solve_affine_gj_batched``: the square-padded ``[A | b]`` through
    kernel 3's plain version against the JAX kernel in interpret mode,
    and the same sets as the loop with partial pivoting."""
    a, b = _systems(m, n, seed=m + n)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    augj, tolj = jsolve.augment_square_padded(aj, bj, None)
    augt, tolt = tsolve.augment_square_padded(at, bt, None)
    np.testing.assert_array_equal(augt.numpy(), np.asarray(augj))
    np.testing.assert_allclose(tolt.numpy(), np.asarray(tolj), rtol=1e-6)
    before = gj.LAUNCHES
    st = tsolve.solve_affine_gj_batched(at, bt)
    assert gj.LAUNCHES == before          # the CPU runs the plain version
    _assert_affine(jsolve.solve_affine_gj_batched(aj, bj, interpret=True),
                   st)
    _assert_affine(jsolve.solve_batched(aj, bj, pivot_rule="partial"), st)


def test_kernel_affine_reach_mirrors_the_reference():
    """The big reach: ``[s, s + 1]`` to s = 423, as the reference's
    ``solve_affine_gj_supported`` (VMEM_TILE_BUDGET_BIG)."""
    for s in (1, 64, 236, 237, 256, 400, 422, 423, 424, 425, 448):
        assert tsolve.solve_affine_gj_supported(s, s) == \
            jsolve.solve_affine_gj_supported(s, s), s
    assert tsolve.solve_affine_gj_supported(423, 300)
    assert not tsolve.solve_affine_gj_supported(300, 424)


@pytest.mark.parametrize("m,n,backend,route", [
    (6, 5, "auto", "kernel"), (300, 423, "auto", "kernel"),
    (424, 10, "auto", "blocked"), (430, 430, "pallas", "loop"),
    (430, 430, "blocked", "blocked"), (100, 100, "blocked", "loop"),
    (6, 5, "loop", "loop")])
def test_affine_dispatch_routes(monkeypatch, m, n, backend, route):
    """``affine_solve_batched`` and ``nullspace_batched``: kernel 3 where
    ``[s, s + 1]`` is in its big reach (s ≤ 423), the blocked RREF from
    max(M, N) = 256, else the loop, as ``dispatch.py:341-383`` routes."""
    from linalg_solver_tpu_torch.ops import dispatch

    rref_blocked = importlib.import_module(
        "linalg_solver_tpu_torch.ops.rref_blocked")

    calls = []
    for mod, name, tag in ((tsolve, "solve_affine_gj_batched", "kernel"),
                           (rref_blocked, "solve_affine_blocked_batched",
                            "blocked"),
                           (tsolve, "solve_batched", "loop")):
        monkeypatch.setattr(mod, name, lambda *a, _t=tag, **k:
                            calls.append(_t))
    a, b = torch.zeros(1, m, n), torch.zeros(1, m)
    dispatch.affine_solve_batched(a, b, backend=backend)
    dispatch.nullspace_batched(a, backend=backend)
    assert calls == [route, route]


def test_affine_dispatch_matches_jax():
    """``affine_solve_batched(auto)`` (kernel 3's plain version here)
    against the JAX package's ``"loop"``, and the loop with a per-matrix
    ``tol [B]`` against each system solved alone."""
    from linalg_solver_tpu.ops import dispatch as jdispatch
    from linalg_solver_tpu_torch.ops import dispatch

    a, b = _systems(6, 5, seed=11)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    _assert_affine(jdispatch.affine_solve_batched(
        jnp.asarray(a), jnp.asarray(b), backend="loop"),
        dispatch.affine_solve_batched(at, bt))
    tol = torch.tensor([1e-6, 1e-3, 1e-5, 0.0])
    got = dispatch.affine_solve_batched(at, bt, backend="loop", tol=tol)
    for i in range(4):
        one = tsolve.solve(at[i], bt[i], tol=float(tol[i]),
                           pivot_rule="partial")
        for f in got._fields:
            assert torch.equal(getattr(got, f)[i], getattr(one, f)), (i, f)
    ns = dispatch.nullspace_batched(at)
    assert ns.is_consistent.all() and ns.dim.tolist() == [0, 1, 1, 5]
