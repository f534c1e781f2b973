"""Tridiagonal batches shared by the tests of the Sturm bisection's
schedule (``tests/test_torch_sturm_schedule.py`` on the CPU against the
JAX package, ``tests/test_torch_cuda.py`` on the card): seeded numpy
arrays ``(d [B, n], e [B, n − 1])`` in float64, one schedule case each.
Imports neither JAX nor the JAX package.

Every value stays a normal number under bisection, because XLA on the
CPU flushes subnormals and PyTorch does not."""

import numpy as np
import torch


def split_repeated(n=96, seed=0):
    """Two lanes of n/4 copies of one 4×4 block, split by zero
    off-diagonals: each eigenvalue n/4 times exactly, so its intervals
    never separate."""
    rng = np.random.RandomState(seed)
    blk_d, blk_e = rng.randn(2, 4), rng.randn(2, 3)
    e = np.zeros((2, n - 1))
    for j in range(n // 4):
        e[:, 4 * j:4 * j + 3] = blk_e
    return np.tile(blk_d, (1, n // 4)), e


def nan_lane(n=64, seed=1):
    """Three Gaussian lanes, a NaN on lane 1's diagonal: its enclosure,
    intervals and eigenvalues are NaN."""
    rng = np.random.RandomState(seed)
    d, e = rng.randn(3, n), rng.randn(3, n - 1)
    d[1, n // 3] = np.nan
    return d, e


def converged_lane(n=128, seed=2):
    """Lane 0 split into 1×1 blocks within one binade around 1e-31: its
    enclosure is narrower than the 1e-30 tolerance on entry; lane 1
    Gaussian keeps the batch running."""
    rng = np.random.RandomState(seed)
    d = np.stack([1e-31 * (1 + 0.9 * rng.rand(n)), rng.randn(n)])
    e = np.stack([np.zeros(n - 1), rng.randn(n - 1)])
    return d, e


def zero_eigenvalues(n=65, seed=3):
    """Lane 0 with a zero diagonal and odd n: an eigenvalue exactly at 0,
    where the relative tolerance is the smallest, so the batch runs longer
    than lane 1 (Gaussian) alone: a tail of steps that count one midpoint
    (45 against 31 steps in float32, 64 against 60 in float64)."""
    rng = np.random.RandomState(seed)
    d = np.stack([np.zeros(n), rng.randn(n)])
    return d, rng.randn(2, n - 1)


def wide_range(n=64, seed=5):
    """Lane 0 with a diagonal of Gaussians times 1e19, so that the pivots
    leave the range of the kernel's fast float32 division (2^60) and its
    groups fall back to the exact one; lane 1 with off-diagonals near
    1e-16, whose squares are below that range (the whole lane exact);
    lane 2 Gaussian."""
    rng = np.random.RandomState(seed)
    d, e = rng.randn(3, n), rng.randn(3, n - 1)
    d[0] *= 1e19
    e[1] *= 1e-16
    return d, e


def single(n=1, seed=4):
    """n = 1: two 1×1 lanes."""
    rng = np.random.RandomState(seed)
    return rng.randn(2, n), np.zeros((2, n - 1))


CASES = {f.__name__: f for f in (split_repeated, nan_lane, converged_lane,
                                  zero_eigenvalues, wide_range, single)}


def nan_equal(x, y):
    """The same bit patterns, or NaN in both."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    return bool(((x.view(ints) == y.view(ints))
                 | (x.isnan() & y.isnan())).all())
