"""The port's pivoted Gauss–Jordan (``linalg_solver_tpu_torch.ops
.kernels.gauss_jordan``) against the JAX package's Pallas kernel
``gj_kernel`` in interpret mode, fed the same numpy inputs.  On the CPU
the port runs its plain version; ``test_torch_cuda.py`` holds the CUDA
kernel against it on a card.

Tolerance: ``perm`` exactly; ``reduced`` and ``pivots`` to 1e-5 of the
matrix's largest entry.  Both sides run the same f32 operations in the
same order (the update ``x − c·p`` rounded once, as XLA's CPU backend
fuses it), so they agree to the bit on finite input; 1e-5 is the bound
the port holds every kernel to."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops.pallas import gj_kernel as jgj
from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

RTOL = 1e-5


def _both(a, tol=None):
    rj = jgj.gauss_jordan_tiled(
        jnp.asarray(a), tol=None if tol is None else jnp.asarray(tol),
        interpret=True)
    rt = gj.gauss_jordan_tiled(
        torch.from_numpy(a), None if tol is None else torch.from_numpy(tol))
    return rj, rt


def _assert_agree(rj, rt):
    np.testing.assert_array_equal(rt.perm.numpy(), np.asarray(rj.perm))
    assert rt.perm.dtype == torch.int32
    for got, want in ((rt.reduced, rj.reduced), (rt.pivots, rj.pivots)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == np.float32
        for i in range(want.shape[0]):
            scale = max(np.abs(want[i]).max(), 1e-30)
            assert np.abs(got[i] - want[i]).max() <= RTOL * scale, i


@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("wide", ["n", "n+1", "2n"])
def test_matches_jax_kernel(n, wide):
    w = {"n": n, "n+1": n + 1, "2n": 2 * n}[wide]
    a = np.random.RandomState(n + w).randn(3, n, w).astype(np.float32)
    _assert_agree(*_both(a))


def test_antidiagonal_pivot_swaps():
    """Every pivot sits off the diagonal: perm is the reversal."""
    a = np.zeros((2, 4, 4), np.float32)
    for i in range(4):
        a[:, i, 3 - i] = float(i + 1)
    rj, rt = _both(a)
    _assert_agree(rj, rt)
    assert rt.perm[0].tolist() == [3, 2, 1, 0]


def test_rank_deficient_batch_skips_columns():
    rng = np.random.RandomState(4)
    low = np.einsum("bik,bkj->bij", rng.randn(3, 8, 3), rng.randn(3, 3, 8))
    a = np.concatenate([low, rng.randn(1, 8, 8)]).astype(np.float32)
    tol = np.full(4, 1e-4, np.float32)
    rj, rt = _both(a, tol)
    _assert_agree(rj, rt)
    nz = (rt.pivots.abs() > 0).sum(dim=1).tolist()
    assert nz == [3, 3, 3, 8]


def test_zero_column_before_a_pivot():
    a = np.array([[[0.0, 1.0, 2.0], [0.0, 0.0, 3.0], [0.0, 4.0, 5.0]]],
                 np.float32)
    rj, rt = _both(a)
    _assert_agree(rj, rt)
    assert float(rt.pivots[0, 0]) == 0.0


def test_per_matrix_tol():
    """The same matrix under three thresholds: the smallest pivot passes
    only the lowest one."""
    d = np.diag([4.0, 2.0, 1e-3, 1.0]).astype(np.float32)
    a = np.stack([d, d, d])
    tol = np.array([0.0, 1e-2, 3.0], np.float32)
    rj, rt = _both(a, tol)
    _assert_agree(rj, rt)
    assert (rt.pivots.abs() > 0).sum(dim=1).tolist() == [4, 3, 1]


def test_nan_column_poisons_like_the_one_hot_sums():
    """A NaN makes the pivot row's entry in its column NaN (the TPU
    kernel reads the row as a one-hot sum); the non-finite pattern and
    perm follow the JAX kernel."""
    a = np.random.RandomState(9).randn(2, 6, 12).astype(np.float32)
    a[0, 2, 4] = np.nan
    a[1, 1, 9] = np.inf
    rj, rt = _both(a)
    np.testing.assert_array_equal(rt.perm.numpy(), np.asarray(rj.perm))
    np.testing.assert_array_equal(
        np.isfinite(rt.reduced.numpy()), np.isfinite(np.asarray(rj.reduced)))


def _well(B, n, seed, shift=None):
    rng = np.random.RandomState(seed)
    shift = 4.0 * np.sqrt(n) if shift is None else shift
    return (rng.randn(B, n, n) + shift * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [8, 33, 64])
def test_inverse_matches_jax(n):
    a = _well(4, n, seed=n)
    xj = np.asarray(jgj.inverse_batched(jnp.asarray(a), interpret=True))
    xt = gj.inverse_batched(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=RTOL * np.abs(xj).max())
    r = np.einsum("bij,bjk->bik", a.astype(np.float64), xt) - np.eye(n)
    assert np.abs(r).max() <= 5e-5


@pytest.mark.parametrize("k", [None, 3], ids=["vector", "matrix"])
def test_solve_matches_jax(k):
    a = _well(4, 16, seed=3)
    rng = np.random.RandomState(5)
    b = rng.randn(4, 16).astype(np.float32) if k is None else rng.randn(
        4, 16, k).astype(np.float32)
    xj = np.asarray(jgj.solve_batched(jnp.asarray(a), jnp.asarray(b),
                                      interpret=True))
    xt = gj.solve_batched(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert xt.shape == b.shape
    np.testing.assert_allclose(xt, xj, rtol=0, atol=RTOL * np.abs(xj).max())


@pytest.mark.parametrize("n", [8, 32, 64])
def test_det_matches_jax(n):
    """I + 0.1·randn/√n keeps |det| well inside f32 range."""
    rng = np.random.RandomState(n)
    a = (np.eye(n) + 0.1 * rng.randn(4, n, n) / np.sqrt(n)).astype(
        np.float32)
    a[1] = a[1][::-1]            # pivots off the diagonal: perm matters
    a[2, [0, 1]] = a[2, [1, 0]]  # one swap: the sign flips
    dj = np.asarray(jgj.det_batched(jnp.asarray(a), interpret=True))
    dt = gj.det_batched(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=RTOL)
    np.testing.assert_allclose(dt, np.linalg.det(a.astype(np.float64)),
                               rtol=1e-4)


def test_perm_parity_matches_jax():
    rng = np.random.RandomState(0)
    perms = np.stack([rng.permutation(7) for _ in range(20)]).astype(
        np.int32)
    want = np.asarray(jgj._perm_parity(jnp.asarray(perms)))
    got = gj._perm_parity(torch.from_numpy(perms)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 8), (2, 3), (6, 10), (12, 5)])
def test_rank_matches_jax(shape):
    """Square, wide and tall; ranks 2, full and deficient in one batch."""
    m, n = shape
    rng = np.random.RandomState(m * n)
    full = rng.randn(2, m, n)
    low = np.einsum("bik,bkj->bij", rng.randn(2, m, 2), rng.randn(2, 2, n))
    a = np.concatenate([full, low]).astype(np.float32)
    want = np.asarray(jgj.rank_batched(jnp.asarray(a), interpret=True))
    got = gj.rank_batched(torch.from_numpy(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [min(m, n)] * 2 + [min(2, m, n)] * 2


def test_rank_with_given_tol():
    a = np.diag([3.0, 1e-3, 1.0]).astype(np.float32)[None].repeat(2, 0)
    tol = np.array([1e-4, 1e-2], np.float32)
    want = np.asarray(jgj.rank_batched(jnp.asarray(a), tol=jnp.asarray(tol),
                                       interpret=True))
    got = gj.rank_batched(torch.from_numpy(a), torch.from_numpy(tol))
    assert got.tolist() == want.tolist() == [3, 2]


def test_reach():
    """The mirror of the .cu's shared-memory formula at its boundaries
    (the card test checks the formula itself)."""
    assert gj.fits(167, 334) and not gj.fits(168, 336)   # inverse
    assert gj.fits(236, 236) and not gj.fits(238, 238)   # det, rank
    assert gj.fits(64, 65) and not gj.fits(64, 63)
    with pytest.raises(ValueError, match="W >= N"):
        gj.gauss_jordan_tiled(torch.zeros(1, 4, 3))
    with pytest.raises(ValueError, match="tol"):
        gj.gauss_jordan_tiled(torch.zeros(2, 4, 4), torch.zeros(3))
