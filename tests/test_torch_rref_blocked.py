"""The port's blocked rank-revealing Gauss–Jordan
(``linalg_solver_tpu_torch.ops.rref_blocked``) against the JAX package's
``ops.rref_blocked``, fed the same numpy inputs at nb = 8, so that a
20-wide system takes three panels (the last one narrower) and the
trailing update runs on both sides of each.

Exact: ``perm`` and which pivots are zero, ``dim``, ``gen_mask``,
``is_consistent``, ranks.  Values: within 1e-5 of each system's largest
entry.  The panel steps run the reference's operations in its order; the
trailing update's products and triangular solve sum in another order
than XLA's, which stays well inside that (≤ 4e-7 relative measured)."""

import importlib

import jax.numpy as jnp
import numpy as np
import torch

trb = importlib.import_module("linalg_solver_tpu_torch.ops.rref_blocked")
tsolve = importlib.import_module("linalg_solver_tpu_torch.ops.solve")

jrb = importlib.import_module("linalg_solver_tpu.ops.rref_blocked")
jsolve = importlib.import_module("linalg_solver_tpu.ops.solve")

RTOL = 1e-5
NB = 8


def _systems():
    """Three 20×17 systems: a repeated column with a consistent b, a zero
    row and a row three times another with b off the range, random."""
    rng = np.random.RandomState(1)
    a = rng.randn(3, 20, 17).astype(np.float32)
    a[0, :, 5] = a[0, :, 2]
    b = rng.randn(3, 20).astype(np.float32)
    b[0] = a[0] @ rng.randn(17).astype(np.float32)
    a[1, 4] = 0.0
    a[1, 7] = 3 * a[1, 2]
    return a, b


def _close(x, y):
    for i in range(x.shape[0]):
        assert np.abs(x[i] - y[i]).max() <= RTOL * max(
            np.abs(x[i]).max(), 1.0), i


def test_rref_blocked_matches_jax():
    a, b = _systems()
    aug, tol = tsolve.augment_square_padded(
        torch.from_numpy(a), torch.from_numpy(b), None)
    rt = trb.rref_blocked(aug, tol=tol, nb=NB)
    rj = jrb.rref_blocked(jnp.asarray(aug.numpy()),
                          tol=jnp.asarray(tol.numpy()), nb=NB)
    np.testing.assert_array_equal(rt.perm.numpy(), np.asarray(rj.perm))
    np.testing.assert_array_equal(rt.pivots.numpy() != 0,
                                  np.asarray(rj.pivots) != 0)
    _close(np.asarray(rj.reduced), rt.reduced.numpy())
    _close(np.asarray(rj.pivots), rt.pivots.numpy())


def test_blocked_affine_solve_matches_jax_and_the_loop():
    a, b = _systems()
    st = trb.solve_affine_blocked_batched(torch.from_numpy(a),
                                          torch.from_numpy(b), nb=NB)
    sj = jrb.solve_affine_blocked_batched(jnp.asarray(a), jnp.asarray(b),
                                          nb=NB)
    sl = tsolve.solve_batched(torch.from_numpy(a), torch.from_numpy(b),
                              pivot_rule="partial")
    for want in (sj, sl):
        for f in ("gen_mask", "dim", "is_consistent"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(want, f)))
        for f in ("particular", "generators"):
            _close(np.asarray(getattr(want, f)), getattr(st, f).numpy())
    assert st.is_consistent.tolist() == [True, False, False]
    assert st.dim.tolist() == [1, 0, 0]


def test_blocked_rank_matches_jax():
    """Rectangular both ways (square-padded), constructed ranks."""
    rng = np.random.RandomState(2)
    low = np.einsum("bik,bkj->bij", rng.randn(3, 20, 6),
                    rng.randn(3, 6, 13)).astype(np.float32)
    low[2] = 0.0
    for a in (low, np.ascontiguousarray(low.transpose(0, 2, 1))):
        rt = trb.rank_blocked_batched(torch.from_numpy(a), nb=NB)
        rj = np.asarray(jrb.rank_blocked_batched(jnp.asarray(a), nb=NB))
        assert rt.dtype == torch.int32
        assert rt.tolist() == rj.tolist() == [6, 6, 0]
