"""The port's 1-norm condition estimate (``linalg_solver_tpu_torch.ops
.cond``) against the JAX package's ``ops.cond``, fed the same numpy
inputs.

The port takes the factors of its ``ops.lu`` (the reference's pivots)
and solves their triangles with the library instead of the reference's
row loops.  Values within 1e-5 relative: the transposed solve, κ₁ and
rcond, and exactly where they are inf or 0 (a singular lane, a zero
lane)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import cond as jcond
from linalg_solver_tpu.ops.lu import lu_factor_batched as jlu
from linalg_solver_tpu_torch.ops import cond as tcond
from linalg_solver_tpu_torch.ops.lu import lu_factor_batched as tlu

RTOL = 1e-5
N = 12


def _batch(seed=0):
    """Gaussian lanes, of which lane 1 is ill-conditioned (a column nearly
    repeated), lane 2 singular (a repeated row) and lane 3 zero."""
    rng = np.random.RandomState(seed)
    a = rng.randn(4, N, N).astype(np.float32)
    a[1, :, 7] = a[1, :, 6] + 1e-3 * rng.randn(N).astype(np.float32)
    a[2, 5] = a[2, 4]
    a[3] = 0.0
    return a


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= rtol * np.abs(want[fin]))


@pytest.mark.parametrize("k", [None, 3])
def test_lu_solve_transposed_matches_jax(k):
    a = _batch()[:2]
    rng = np.random.RandomState(1)
    b = rng.randn(2, N).astype(np.float32) if k is None else rng.randn(
        2, N, k).astype(np.float32)
    want = np.asarray(jcond.lu_solve_transposed_batched(jlu(jnp.asarray(a)),
                                                        jnp.asarray(b)))
    res = tlu(torch.from_numpy(a))
    got = tcond.lu_solve_transposed_batched(res, torch.from_numpy(b))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    one = tcond.lu_solve_transposed(type(res)(*(t[0] for t in res)),
                                    torch.from_numpy(b[0]))
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("iters", [1, 5])
def test_cond1_and_rcond_match_jax(iters):
    a = _batch()
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    kappa = tcond.cond1_est_batched(at, iters=iters)
    _close(kappa, jcond.cond1_est_batched(aj, iters=iters))
    rc = tcond.rcond_batched(at, iters=iters)
    _close(rc, jcond.rcond_batched(aj, iters=iters))
    assert rc[2:].tolist() == [0.0, 0.0] and bool((rc[:2] > 0).all())
    # a lower bound on the true κ₁, within a small factor of it once the
    # power method has run
    if iters == 1:
        return
    exact = np.array([np.linalg.cond(x.astype(np.float64), 1) for x in a[:2]])
    assert np.all(kappa[:2].numpy() <= exact * (1 + 1e-4))
    assert np.all(kappa[:2].numpy() >= exact / 3)
