"""The port's LU loop (``linalg_solver_tpu_torch.ops.lu``, the ``"loop"``
backend and correctness oracle) against the JAX package's ``ops.lu``,
fed the same numpy inputs: swaps, a zero pivot column, a singular
matrix, and a pivot threshold.

Exact: ``perm``, ``sign`` and ``ok``.  Values (packed L\\U, solutions,
determinants): within 1e-5 relative.  The factorization runs the same
f32 operations in the same order and agrees to the bit on finite input
(the port skips the reference's multiplications by zero outside the
trailing block); the substitutions' dot products sum in another order."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import lu as jlu
from linalg_solver_tpu_torch.ops import lu as tlu

RTOL = 1e-5


def _batch():
    """Four 9×9 matrices: Gaussian (swaps at every step), a zero first
    column (no pivot there: not ok), all zero, Gaussian plus 6·I."""
    rng = np.random.RandomState(21)
    a = rng.randn(4, 9, 9).astype(np.float32)
    a[1, :, 0] = 0.0
    a[2] = 0.0
    a[3] += 6 * np.eye(9, dtype=np.float32)
    return a


@pytest.mark.parametrize("tol", [0.0, 0.5], ids=["tol0", "tol_half"])
def test_lu_factor_batched_matches_jax(tol):
    a = _batch()
    rj = jlu.lu_factor_batched(jnp.asarray(a), tol=tol)
    rt = tlu.lu_factor_batched(torch.from_numpy(a), tol=tol)
    np.testing.assert_array_equal(rt.perm.numpy(), np.asarray(rj.perm))
    np.testing.assert_array_equal(rt.sign.numpy(), np.asarray(rj.sign))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.tolist() == ([True, False, False, True] if tol == 0.0
                              else np.asarray(rj.ok).tolist())
    lj, lt = np.asarray(rj.lu), rt.lu.numpy()
    for i in range(4):
        assert np.abs(lt[i] - lj[i]).max() <= RTOL * max(
            np.abs(lj[i]).max(), 1.0), i
    # the input is left as it was
    assert np.array_equal(a, _batch())


@pytest.mark.parametrize("k", [None, 3], ids=["vector", "matrix"])
def test_solve_lu_batched_matches_jax(k):
    a = _batch()[[0, 3]]
    rng = np.random.RandomState(22)
    b = rng.randn(*((2, 9) if k is None else (2, 9, k))).astype(np.float32)
    xj = np.asarray(jlu.solve_lu_batched(jnp.asarray(a), jnp.asarray(b)))
    xt = tlu.solve_lu_batched(torch.from_numpy(a), torch.from_numpy(b))
    assert xt.shape == b.shape
    np.testing.assert_allclose(xt.numpy(), xj, rtol=RTOL,
                               atol=RTOL * np.abs(xj).max())
    r = np.einsum("bij,bj...->bi...", a.astype(np.float64),
                  xt.numpy().astype(np.float64)) - b
    assert np.abs(r).max() <= 1e-5 * np.abs(b).max() * 10


def test_det_lu_and_single_forms_match_jax():
    a = _batch()
    dj = np.asarray(jlu.det_lu_batched(jnp.asarray(a)))
    dt = tlu.det_lu_batched(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=0)
    assert dt[1] == 0.0 and dt[2] == 0.0
    want = np.linalg.det(a[[0, 3]].astype(np.float64))
    np.testing.assert_allclose(dt[[0, 3]], want, rtol=1e-4)
    one = tlu.det_lu(torch.from_numpy(a[3]))
    assert float(one) == float(dt[3])
    b = np.arange(9, dtype=np.float32)
    x1 = tlu.solve_lu(torch.from_numpy(a[3]), torch.from_numpy(b))
    res = tlu.lu_factor(torch.from_numpy(a[3]))
    assert torch.equal(x1, tlu.lu_solve(res, torch.from_numpy(b)))
    np.testing.assert_allclose(
        x1.numpy(), np.asarray(jlu.solve_lu(jnp.asarray(a[3]),
                                            jnp.asarray(b))),
        rtol=RTOL, atol=RTOL)
