"""The port's Sturm bisection and twisted-factorization eigenvectors
(``ops.sturm``; on the CPU the bisection kernel's plain version) against
the JAX package's, on the JAX tests' seeded shapes:

- counts equal at arbitrary points, a split chain (zero off-diagonals)
  included;
- eigenvalues equal to the bit (the same IEEE operations in the same
  order), ``converged`` equal; the 2/−1 Laplacian against its closed form
  and a repeated spectrum with its multiplicities;
- eigenvectors to 1e-5 in each column's sign-fixed difference, the
  residuals to 1e-6 of ‖T‖ and ``ok`` equal, n = 1 included;
- the kernel wrapper's plain version: bitwise the JAX counts, its step
  count where the loop stops early, and its tolerance rule;
- the bisection's operands and step count as the main call makes them.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from linalg_solver_tpu.ops import sturm as jst
from linalg_solver_tpu_torch.ops import sturm as tst
from linalg_solver_tpu_torch.ops.kernels import sturm as kst


def _trid(B, n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n).astype(np.float32),
            rng.randn(B, n - 1).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_counts_equal():
    d, e = _trid(2, 24, seed=1)
    pts = np.array([[-3.0, -1.0, 0.0, 1.5, 3.0]] * 2, np.float32)
    want = np.asarray(jst.sturm_count_batched(d, e, pts))
    got = tst.sturm_count_batched(*_t(d, e, pts))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    d = np.array([[1.0, 5.0, 2.0, 7.0]], np.float32)
    e = np.array([[0.0, 3.0, 0.0]], np.float32)
    pts = np.array([[0.0, 3.0, 10.0, 2.0]], np.float32)
    assert np.array_equal(tst.sturm_count_batched(*_t(d, e, pts)).numpy(),
                          np.asarray(jst.sturm_count_batched(d, e, pts)))


@pytest.mark.parametrize("B, n, seed", [(3, 32, 2), (2, 7, 9)])
def test_eigenvalues_bitwise(B, n, seed):
    d, e = _trid(B, n, seed=seed)
    want = jst.eigh_tridiagonal_batched(d, e)
    got = tst.eigh_tridiagonal_batched(*_t(d, e))
    assert np.array_equal(got.w.numpy(), np.asarray(want.w))
    assert np.array_equal(got.converged.numpy(), np.asarray(want.converged))
    for b in range(B):
        ref = scipy.linalg.eigh_tridiagonal(
            d[b].astype(np.float64), e[b].astype(np.float64),
            eigvals_only=True)
        assert np.abs(got.w[b].numpy() - ref).max() < 1e-5 * np.abs(
            ref).max()


def test_structured_spectra():
    n = 48
    d = np.full((1, n), 2.0, np.float32)
    e = np.full((1, n - 1), -1.0, np.float32)
    got = tst.eigh_tridiagonal_batched(*_t(d, e))
    closed = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
    assert np.abs(got.w[0].numpy() - np.sort(closed)).max() < 1e-5
    assert np.array_equal(got.w.numpy(),
                          np.asarray(jst.eigh_tridiagonal_batched(d, e).w))
    d = np.array([[2.0, 2.0, 2.0, 5.0]], np.float32)
    e = np.zeros((1, 3), np.float32)
    got = tst.eigh_tridiagonal_batched(*_t(d, e))
    np.testing.assert_allclose(got.w[0].numpy(), [2, 2, 2, 5], atol=1e-5)
    assert bool(got.converged.all())


@pytest.mark.parametrize("B, n, seed", [(3, 32, 3), (1, 16, 4)])
def test_eigenvectors_match(B, n, seed):
    d, e = _trid(B, n, seed=seed)
    w = jst.eigh_tridiagonal_batched(d, e).w
    want = jst.tridiag_eigenvectors_batched(d, e, w)
    got = tst.tridiag_eigenvectors_batched(*_t(d, e, np.asarray(w)))
    assert np.array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert bool(got.ok.all())
    V, Vj = got.V.numpy(), np.asarray(want.V)
    sign = np.sign((V * Vj).sum(axis=1, keepdims=True))
    assert np.abs(V * sign - Vj).max() < 1e-5
    assert np.abs(got.resid.numpy() - np.asarray(want.resid)).max() < 1e-6
    assert got.resid.max() < 1e-5


def test_n1():
    d = np.array([[3.0], [-2.0]], np.float32)
    e = np.zeros((2, 0), np.float32)
    got = tst.eigh_tridiagonal_batched(*_t(d, e))
    assert np.array_equal(got.w.numpy(),
                          np.asarray(jst.eigh_tridiagonal_batched(d, e).w))
    vec = tst.tridiag_eigenvectors_batched(*_t(d, e, got.w.numpy()))
    want = jst.tridiag_eigenvectors_batched(d, e, np.asarray(got.w))
    assert np.array_equal(vec.V.numpy(), np.asarray(want.V))
    assert np.array_equal(vec.ok.numpy(), np.asarray(want.ok))


def test_plain_bisection_stops_early_and_agrees():
    d, e = _trid(2, 12, seed=11)
    dt, et = _t(d, e)
    e2 = torch.cat([torch.zeros(2, 1), et * et], dim=1)
    pm = tst._pivmin(et, torch.float32)
    a = torch.full((2, 12), -20.0)
    b = torch.full((2, 12), 20.0)
    a1, b1, steps = kst.bisect(dt, e2, pm, a, b)
    assert 0 < int(steps) < kst.STEPS
    assert not bool(((b1 - a1) > kst.tolerance(a1, b1)).any())
    assert torch.equal(a, torch.full((2, 12), -20.0))   # inputs kept
    # the same plain version on the counts the JAX package gives
    x = 0.5 * (a1 + b1)
    assert np.array_equal(kst.sturm_count(dt, e2, pm, x).numpy(),
                          np.asarray(jst.sturm_count_batched(
                              d, e, x.numpy())))
    assert kst.fits(4096, torch.float32) and not kst.fits(40000,
                                                          torch.float32)


def test_bisect_operands_are_the_main_calls():
    """``bisect_operands`` is the set-up ``eigh_tridiagonal_batched``
    bisects from: enclosures around every eigenvalue, the same w from
    them, and ``LAST_STEPS`` the steps of that call."""
    d, e = _trid(3, 20, seed=5)
    dt, et = _t(d, e)
    ops = tst.bisect_operands(dt.double(), et.double())
    assert all(t.dtype == torch.float64 for t in ops)
    dd, e2, pm, a0, b0 = tst.bisect_operands(dt, et)
    assert torch.equal(e2[:, 1:], et * et) and bool((e2[:, 0] == 0).all())
    assert torch.equal(pm, tst._pivmin(et, torch.float32))
    res = tst.eigh_tridiagonal_batched(dt, et)
    steps = int(kst.LAST_STEPS)
    assert bool((a0 < res.w).all()) and bool((res.w < b0).all())
    a, b, ref_steps = kst.bisect_reference(dd, e2, pm, a0, b0)
    assert steps == int(ref_steps) and 0 < steps < kst.STEPS
    assert torch.equal(res.w, 0.5 * (a + b))
