"""The port's block cyclic reduction (``linalg_solver_tpu_torch.ops.
banded``) against the JAX package's ``ops.banded`` on the same numpy
inputs, and against scipy's ``solve_banded`` in float64.  The two run the
same reduction with library block solves, so solutions agree to 1e-5 of
each lane's largest entry, and ``ok`` exactly (a singular lane is
flagged by both)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import banded as jb
from linalg_solver_tpu_torch.ops import banded


def _blocks(B, K, nb, seed):
    rng = np.random.RandomState(seed)
    dl = rng.randn(B, K, nb, nb).astype(np.float32)
    du = rng.randn(B, K, nb, nb).astype(np.float32)
    d = (rng.randn(B, K, nb, nb) + 8.0 * nb * np.eye(nb)).astype(np.float32)
    return dl, d, du


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i in range(got.shape[0]):
        assert np.abs(got[i] - want[i]).max() <= rtol * np.abs(want[i]).max()


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("k", [None, 2])
def test_block_tridiag_matches_jax(k):
    """K = 5 blocks of 3 (three reduction steps); lane 1 all-zero on the
    diagonal: singular, flagged on both."""
    dl, d, du = _blocks(3, 5, 3, seed=11)
    d[1] = 0.0
    rng = np.random.RandomState(12)
    b = rng.randn(*((3, 5, 3) if k is None else (3, 5, 3, k))).astype(
        np.float32)
    rt = banded.block_tridiag_solve_batched(_t(dl), _t(d), _t(du), _t(b))
    rj = jb.block_tridiag_solve_batched(jnp.asarray(dl), jnp.asarray(d),
                                        jnp.asarray(du), jnp.asarray(b))
    assert rt.ok.tolist() == np.asarray(rj.ok).tolist() == [True, False,
                                                            True]
    _close(rt.x.numpy()[[0, 2]], np.asarray(rj.x)[[0, 2]])
    assert not np.isfinite(rt.x[1].numpy()).all()


@pytest.mark.parametrize("kb,n,nb", [(2, 20, None), (4, 30, 8)])
def test_banded_matches_jax_and_scipy(kb, n, nb):
    """N = 30 with nb = 8 pads to 32 with identity rows."""
    from scipy.linalg import solve_banded

    rng = np.random.RandomState(kb * 10 + n)
    ab = rng.randn(2, 2 * kb + 1, n).astype(np.float32)
    ab[:, kb] += 4.0 * (2 * kb + 1)
    b = rng.randn(2, n).astype(np.float32)
    rt = banded.banded_solve_batched(_t(ab), _t(b), kb=kb, nb=nb)
    rj = jb.banded_solve_batched(jnp.asarray(ab), jnp.asarray(b), kb=kb,
                                 nb=nb)
    assert bool(rt.ok.all()) and bool(np.asarray(rj.ok).all())
    _close(rt.x, rj.x)
    for i in range(2):
        want = solve_banded((kb, kb), ab[i].astype(np.float64),
                            b[i].astype(np.float64))
        assert np.abs(rt.x[i].numpy() - want).max() <= 1e-4 * max(
            np.abs(want).max(), 1.0)
    with pytest.raises(ValueError, match="rows"):
        banded.banded_solve_batched(_t(ab[:, :-1]), _t(b), kb=kb)
