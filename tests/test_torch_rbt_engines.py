"""The rest of the port's RBT family (``linalg_solver_tpu_torch.ops.rbt``
``engine="hybrid"`` / ``"recursive"``, ``fallback="pivoted"`` / ``False``,
and ``ops.lu_large``'s ``diag_engine="pivoted"``) against the JAX package
on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode with
``factor_precision="float32"``; the port runs its plain versions on the
CPU, fed the JAX butterfly draws.  The batch is ``_probe_batch``'s: system
1 has a zero first pivot under the main draw (flagged, and caught by the
rescue), system 3 is all zero (every rung fails).  Solutions and inverses
agree to 1e-5 of each system's largest entry (``RTOL`` of
``tests/test_torch_rbt_phases.py``), and the rescue-free passes raise
exactly the same per-system flags."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import lu_large as jlarge
from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu_torch.ops import lu_large, rbt
from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot

from test_torch_rbt_phases import _assert_close, _jax_diags, _probe_batch

B, N, NB = 4, 64, 32


def _nan_equal(x, y):
    return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def _resid(a, b, x):
    r = np.einsum("bij,bjk->bik", a.astype(np.float64),
                  np.asarray(x, np.float64).reshape(b.shape[0], N, -1))
    return np.abs(r - b.reshape(r.shape)).max(axis=(1, 2))


@pytest.mark.parametrize("engine,fallback,k", [
    ("hybrid", "redraw", 1), ("recursive", "redraw", 16),
    ("hybrid", "pivoted", 16), ("recursive", "pivoted", 1),
])
def test_solve_engines_match_jax(engine, fallback, k):
    a, rng = _probe_batch(B, N, seed=71 + k)
    b = rng.randn(B, N, k).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    draw = _jax_diags(N, rbt.MAIN_SEEDS)

    _, bad = rbt._solve_core(at, bt, draw, NB, 2, "float32", engine=engine)
    _, bad_j = jrbt._solve_core(jnp.asarray(a), jnp.asarray(b), NB, 2,
                                "float32", 2, rbt.MAIN_SEEDS, True, 32, True,
                                engine=engine)
    assert bad.tolist() == np.asarray(bad_j).tolist()
    assert bad.tolist() == [False, True, False, True]

    bb = bt[:, :, 0] if k == 1 else bt
    xt = rbt.solve_rbt_batched(
        at, bb, diags=draw, rescue_diags=_jax_diags(N, rbt.RESCUE_SEEDS),
        nb=NB, factor_precision="float32", engine=engine,
        fallback=fallback).numpy()
    xj = np.asarray(jrbt.pallas_solve_rbt_batched(
        jnp.asarray(a), jnp.asarray(bb.numpy()), nb=NB,
        factor_precision="float32", engine=engine, fallback=fallback,
        interpret=True))
    assert xt.shape == xj.shape == tuple(bb.shape)
    _assert_close(xt, xj, [0, 1, 2])
    assert _resid(a[:3], b[:3], xt[:3]).max() <= 1e-4
    assert not np.isfinite(xt[3]).all() and not np.isfinite(xj[3]).all()


@pytest.mark.parametrize("engine,fallback", [
    ("hybrid", "redraw"), ("recursive", "pivoted"),
])
def test_inverse_engines_match_jax(engine, fallback):
    a, _ = _probe_batch(B, N, seed=83)
    at = torch.from_numpy(a)
    draw = _jax_diags(N, rbt.MAIN_SEEDS)

    _, bad = rbt._inverse_core(at, draw, NB, 1, "float32", engine=engine)
    _, bad_j = jrbt._inverse_core(jnp.asarray(a), NB, 1, "float32", 2,
                                  rbt.MAIN_SEEDS, True, 8, True,
                                  engine=engine)
    assert bad.tolist() == np.asarray(bad_j).tolist()
    assert bad.tolist() == [False, True, False, True]

    xt = rbt.inverse_rbt_batched(
        at, nb=NB, diags=draw, rescue_diags=_jax_diags(N, rbt.RESCUE_SEEDS),
        engine=engine, fallback=fallback).numpy()
    xj = np.asarray(jrbt.pallas_inverse_rbt_batched(
        jnp.asarray(a), nb=NB, engine=engine, fallback=fallback,
        interpret=True))
    # the zero matrix ends in the pivoted Gauss-Jordan inverse on both
    np.testing.assert_array_equal(xt[3], xj[3])
    _assert_close(xt, xj, [0, 1, 2])
    r = np.einsum("bij,bjk->bik", a[:3].astype(np.float64),
                  xt[:3].astype(np.float64)) - np.eye(N)
    assert np.abs(r).max() <= 5e-5


@pytest.mark.parametrize("engine", ["kernel", "hybrid", "recursive"])
def test_no_fallback_computes_no_flags_and_rescues_nothing(engine):
    """``fallback=False``: the cores return None for the flags, and the
    entry points return the unrescued pass, as the JAX package's
    ``fallback=False`` does (system 1 left as the main draw gives it)."""
    a, rng = _probe_batch(B, N, seed=5)
    b = rng.randn(B, N, 3).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    draw = _jax_diags(N, rbt.MAIN_SEEDS)
    x0, flags = rbt._solve_core(at, bt, draw, NB, 2, "float32",
                                engine=engine, gate=False)
    assert flags is None
    xt = rbt.solve_rbt_batched(at, bt, diags=draw, nb=NB,
                               factor_precision="float32", engine=engine,
                               fallback=False)
    assert _nan_equal(xt, x0)
    xj = np.asarray(jrbt.pallas_solve_rbt_batched(
        jnp.asarray(a), jnp.asarray(b), nb=NB, factor_precision="float32",
        engine=engine, fallback=False, interpret=True))
    _assert_close(xt.numpy(), xj, [0, 2])
    # systems 1 and 3 unrescued: whatever the pass gave them (the
    # recursion's leaves step over a zero pivot and stay finite), finite
    # on both packages or on neither
    for i in (1, 3):
        assert np.isfinite(xt[i].numpy()).all() == np.isfinite(xj[i]).all()
    inv, iflags = rbt._inverse_core(at, draw, NB, 1, "float32",
                                    engine=engine, gate=False)
    assert iflags is None
    assert _nan_equal(rbt.inverse_rbt_batched(
        at, nb=NB, diags=draw, engine=engine, fallback=False), inv)


def test_options_the_reference_takes():
    """``lookahead`` changes nothing; ``"auto"`` keeps its routes (the
    fused kernel at k <= 8, the phase engine past it); the inverse's
    ``"auto"`` and ``"fused"`` are its phase engine, as in the reference;
    depth 1 runs the kernel-4 plain version at depth 1 and agrees with
    the JAX package's depth-1 solve; what is not an option raises.  On
    CPU tensors the new engines launch nothing: kernel 4's and kernel
    5's counts stay where they were."""
    a, rng = _probe_batch(4, N, seed=11)
    a = a[[0, 2]]
    at = torch.from_numpy(a)
    b = torch.from_numpy(rng.randn(2, N, 2).astype(np.float32))
    before = (butterfly.LAUNCHES, lu_nopivot.LAUNCHES)
    for engine in ("hybrid", "recursive"):
        rbt.solve_rbt_batched(at, b, engine=engine)
        rbt.inverse_rbt_batched(at, engine=engine)
    assert (butterfly.LAUNCHES, lu_nopivot.LAUNCHES) == before
    x = rbt.solve_rbt_batched(at, b)
    assert torch.equal(x, rbt.solve_rbt_batched(at, b, engine="auto",
                                                lookahead=1))
    assert torch.equal(x, rbt.solve_rbt_batched(at, b, engine="fused"))
    xk = rbt.solve_rbt_batched(at, b, engine="kernel")
    wide = torch.cat([b] * 5, dim=2)           # k = 10: past the fused kernel
    assert torch.equal(rbt.solve_rbt_batched(at, wide)[:, :, :2], xk)
    with pytest.raises(ValueError, match="engine='fused'"):
        rbt.solve_rbt_batched(at, wide, engine="fused")
    inv = rbt.inverse_rbt_batched(at)
    for engine in ("auto", "fused"):
        assert torch.equal(rbt.inverse_rbt_batched(at, engine=engine), inv)
    assert torch.equal(rbt.inverse_rbt_batched(at, lookahead=2), inv)

    d1 = rbt.diags_from_numpy(*(
        [np.asarray(v) for v in jrbt.rbt_diags(
            jax.random.PRNGKey(key), N, 1, jnp.float32)]
        for key in rbt.MAIN_SEEDS))
    x1 = rbt.solve_rbt_batched(at, b, diags=d1, depth=1, nb=NB,
                               factor_precision="float32")
    x1j = np.asarray(jrbt.pallas_solve_rbt_batched(
        jnp.asarray(a), jnp.asarray(b.numpy()), nb=NB, depth=1,
        factor_precision="float32", engine="kernel", interpret=True))
    _assert_close(x1.numpy(), x1j, [0, 1])
    for bad_kw in ({"engine": "blocked"}, {"fallback": "lu"}, {"depth": 3}):
        with pytest.raises(ValueError):
            rbt.solve_rbt_batched(at, b, **bad_kw)
        with pytest.raises(ValueError):
            rbt.inverse_rbt_batched(at, **bad_kw)


def test_large_solve_pivoted_diagonal_engine_matches_jax():
    """B = 2, N = 256, nb = 64; system 1 is all zero: its block inverse
    is not finite, both packages flag it, and its rescue (the pivoted
    solve) comes back non-finite on both.  The JAX ``_bf16_mm`` rounds
    its factors to bf16 on the CPU, so the factors differ by design and
    the refined solutions are held to 1e-5 of the system's largest
    entry."""
    n, nb = 256, 64
    rng = np.random.RandomState(12)
    a = (rng.randn(2, n, n) + 4.0 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)
    a[1] = 0.0
    b = rng.randn(2, n).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    draw = _jax_diags(n, rbt.MAIN_SEEDS)

    a_p = rbt._butterfly_two_sided_fast(at, *draw, trans=True)
    fac = lu_large._rbt_block_factor(a_p, nb, "pivoted")
    dj = [jrbt.rbt_diags(jax.random.PRNGKey(k), n, 2, jnp.float32)
          for k in rbt.MAIN_SEEDS]
    a_pj = jrbt._butterfly_two_sided_fast(jnp.asarray(a), *dj, trans=True,
                                          interpret=True)
    fac_j = jlarge._rbt_block_factor(a_pj, nb, diag_engine="pivoted")
    assert fac.ok.tolist() == np.asarray(fac_j.ok).tolist() == [True, False]

    xt = lu_large.large_solve_rbt(at, bt, nb=nb, diags=draw,
                                  diag_engine="pivoted").numpy()
    xj = np.asarray(jlarge.large_solve_rbt(
        jnp.asarray(a), jnp.asarray(b), nb=nb, diag_engine="pivoted",
        interpret=True))
    err = np.abs(xt[0] - xj[0]).max()
    assert err <= 1e-5 * np.abs(xj[0]).max(), err
    assert not np.isfinite(xt[1]).all() and not np.isfinite(xj[1]).all()
    r = np.einsum("ij,j->i", a[0].astype(np.float64), xt[0]) - b[0]
    assert np.abs(r).max() / np.abs(b[0]).max() <= 1e-5
    xr = lu_large.large_solve_rbt(at[:1], bt[:1], nb=nb, diags=draw).numpy()
    assert np.abs(xr[0] - xt[0]).max() <= 1e-5 * np.abs(xt[0]).max()
    with pytest.raises(ValueError, match="diag_engine"):
        lu_large.large_solve_rbt(at, bt, nb=nb, diag_engine="kernel")
