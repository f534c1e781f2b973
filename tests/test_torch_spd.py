"""The port's SPD path (``linalg_solver_tpu_torch.ops.spd``) against the
JAX package's ``ops.spd``, fed the same numpy inputs.

Exact: every ``ok`` flag (an indefinite lane included), where the failed
factor is NaN (its lower triangle, as ``jnp.linalg.cholesky`` gives it),
and the pivoted Cholesky's ``rank`` and pivots.  The pivots are compared
where they are defined, ``piv[:, :rank]``: past a lane's rank the
reference keeps taking the argmax of the roundoff left on the diagonal,
which another summation order rounds differently.  Values: within 1e-5
of the largest entry; the Cholesky adjoint within 1e-4 of ``jax.vjp``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import spd as jspd
from linalg_solver_tpu_torch.ops import spd as tspd

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.abs(got[fin] - want[fin]).max() <= rtol * max(
        np.abs(want[fin]).max(), 1.0)


def _spd(B=4, n=8, seed=0):
    """SPD lanes but lane 2, negated (indefinite)."""
    rng = np.random.RandomState(seed)
    g = rng.randn(B, n, n).astype(np.float32)
    a = g @ g.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    a[2] = -a[2]
    return a, rng.randn(B, n).astype(np.float32)


def test_cholesky_matches_jax_and_is_nan_where_it_fails():
    a, _ = _spd()
    rj = jspd.cholesky_batched(jnp.asarray(a))
    rt = tspd.cholesky_batched(torch.from_numpy(a))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.tolist() == [True, True, False, True]
    _close(rt.L, rj.L)
    lower = torch.ones(8, 8, dtype=torch.bool).tril()
    assert rt.L[2].isnan().equal(lower) and bool((rt.L[2][~lower] == 0).all())


@pytest.mark.parametrize("what", ["solve", "solve_k", "inverse", "logdet"])
def test_solve_inverse_logdet_match_jax(what):
    a, b = _spd()
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    if what == "solve":
        rj = jspd.cholesky_solve_batched(aj, jnp.asarray(b))
        rt = tspd.cholesky_solve_batched(at, torch.from_numpy(b))
    elif what == "solve_k":
        bk = np.stack([b, 2 * b], axis=2)
        rj = jspd.cholesky_solve_batched(aj, jnp.asarray(bk))
        rt = tspd.cholesky_solve_batched(at, torch.from_numpy(bk))
    elif what == "inverse":
        rj = jspd.cholesky_inverse_batched(aj)
        rt = tspd.cholesky_inverse_batched(at)
    else:
        rj = jspd.logdet_spd_batched(aj)
        rt = tspd.logdet_spd_batched(at)
    np.testing.assert_array_equal(rt[1].numpy(), np.asarray(rj[1]))
    _close(rt[0], rj[0])


def _psd(seed=3, n=12, ranks=(3, 6, 12)):
    rng = np.random.RandomState(seed)
    mats = []
    for k in ranks:
        g = rng.randn(n, k)
        mats.append(g @ g.T)
    return np.stack(mats).astype(np.float32)


@pytest.mark.parametrize("max_rank", [0, 4])
def test_pivoted_cholesky_matches_jax(max_rank):
    a = _psd()
    rj = jspd.pivoted_cholesky_batched(jnp.asarray(a), max_rank=max_rank)
    rt = tspd.pivoted_cholesky_batched(torch.from_numpy(a),
                                       max_rank=max_rank)
    np.testing.assert_array_equal(rt.rank.numpy(), np.asarray(rj.rank))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    want = [3, 6, 12] if max_rank == 0 else [3, 4, 4]
    assert rt.rank.tolist() == want
    pj = np.asarray(rj.piv)
    for i, k in enumerate(want):
        np.testing.assert_array_equal(rt.piv[i, :k].numpy(), pj[i, :k])
    _close(rt.L, rj.L)
    _close(rt.resid_diag, rj.resid_diag, rtol=1e-4)


def test_pivoted_cholesky_first_index_wins_a_tie():
    """The identity: every diagonal ties, the pivots run 0, 1, 2, …"""
    a = np.tile(np.eye(6, dtype=np.float32), (2, 1, 1))
    rj = jspd.pivoted_cholesky_batched(jnp.asarray(a))
    rt = tspd.pivoted_cholesky_batched(torch.from_numpy(a))
    np.testing.assert_array_equal(rt.piv.numpy(), np.asarray(rj.piv))
    assert rt.piv[0].tolist() == list(range(6))


def test_cholesky_vjp_matches_jax():
    a, _ = _spd(B=3, n=6, seed=5)
    a[2] = -a[2]                  # all SPD
    g = np.random.RandomState(6).randn(3, 6, 6).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jspd.cholesky_batched(x).L, jnp.asarray(a))
    (want,) = vjp(jnp.asarray(g))
    at = torch.tensor(a, requires_grad=True)
    (got,) = torch.autograd.grad(
        (tspd.cholesky_batched(at).L * torch.from_numpy(g)).sum(), at)
    _close(got, want, rtol=1e-4)
