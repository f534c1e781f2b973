"""The port's Gauss–Jordan loop (``linalg_solver_tpu_torch.ops.rref``)
against the JAX package's ``ops.rref.rref_batched``, fed the same numpy
inputs: rank-deficient, rectangular and zero-column matrices under both
pivot rules, integer matrices under ``pivot_rule="first"`` with
``tol=0`` (the exact path's pivot sequence), and a per-matrix ``tol``.

Exact: pivot rows and columns, their count, the event buffer and its
count.  Values (reduced matrix, det): within 1e-5 of each matrix's
largest entry.  Both sides run the same f32 operations in the same
order (the update ``x − f·row`` rounded once, as XLA's CPU backend fuses
it), so on finite input they agree to the bit; 1e-5 is the bound the
port holds every path to.  One JAX compile per case keeps this file
cheap: few shapes."""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

trref = importlib.import_module("linalg_solver_tpu_torch.ops.rref")

jrref = importlib.import_module("linalg_solver_tpu.ops.rref")

RTOL = 1e-5
EXACT = ("pivot_rows", "pivot_cols", "num_pivots", "events", "num_events")


def _float_batch():
    """Four 7×9 matrices: full rank, a row that is twice another, a zero
    column, and rank 2."""
    rng = np.random.RandomState(3)
    a = rng.randn(4, 7, 9).astype(np.float32)
    a[1, 3] = 2 * a[1, 0]
    a[2, :, 2] = 0.0
    a[3] = (rng.randn(7, 2) @ rng.randn(2, 9)).astype(np.float32)
    return a


def _int_batch():
    """Integer 6×7 matrices in [-3, 3]: a row that is the sum of two
    others, a zero first column, a zero matrix."""
    rng = np.random.RandomState(4)
    a = rng.randint(-3, 4, size=(4, 6, 7)).astype(np.float32)
    a[0, 2] = a[0, 0] + a[0, 1]
    a[1, :, 0] = 0.0
    a[3] = 0.0
    return a


def _assert_agree(rj, rt):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)
        assert getattr(rt, f).dtype == torch.int32, f
    red_j, red_t = np.asarray(rj.reduced), rt.reduced.numpy()
    for i in range(red_j.shape[0]):
        scale = max(np.abs(red_j[i]).max(), 1.0)
        assert np.abs(red_t[i] - red_j[i]).max() <= RTOL * scale, i
    np.testing.assert_allclose(rt.det.numpy(), np.asarray(rj.det),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize(
    "batch,rule,tol,bar_col",
    [("float", "partial", 1e-5, None), ("float", "first", 1e-5, 9),
     ("int", "first", 0.0, None), ("int", "partial", 0.0, 6)],
    ids=["partial", "first_bar9", "int_first_exact", "int_partial_bar6"])
def test_rref_batched_matches_jax(batch, rule, tol, bar_col):
    a = _float_batch() if batch == "float" else _int_batch()
    rj = jrref.rref_batched(jnp.asarray(a), bar_col=bar_col, tol=tol,
                            pivot_rule=rule)
    rt = trref.rref_batched(torch.from_numpy(a), bar_col=bar_col, tol=tol,
                            pivot_rule=rule)
    _assert_agree(rj, rt)


def test_integer_first_rule_is_exact():
    """``"first"`` with ``tol=0`` on a matrix whose elimination stays exact
    in f32 (unit pivots: a permutation matrix whose last row is the sum
    of two others, and an integer bar column): the integer rank, the
    exact path's events (swaps and eliminations below, nothing to
    normalise or eliminate above), and
    nothing at all for the zero matrix."""
    a = np.zeros((2, 6, 7), np.float32)
    a[0, :, :6] = np.eye(6, dtype=np.float32)[[3, 0, 5, 1, 4, 2]]
    a[0, 5, :6] = a[0, 0, :6] + a[0, 1, :6]
    a[0, :, 6] = np.arange(6)
    rt = trref.rref_batched(torch.from_numpy(a), tol=0.0,
                            pivot_rule="first")
    rj = jrref.rref_batched(jnp.asarray(a), tol=0.0, pivot_rule="first")
    _assert_agree(rj, rt)
    assert rt.num_pivots.tolist() == [5, 0]
    codes = {trref.EVENT_NAMES[int(c)]
             for c in rt.events[0, :int(rt.num_events[0]), 0]}
    assert codes == {"SWAP", "ELIM_BELOW"}
    assert int(rt.num_events[1]) == 0 and float(rt.det[1]) == 0.0


def test_per_matrix_tol_is_each_matrix_own():
    """A ``[B]`` threshold reduces each matrix as a scalar one would: the
    batch against the same matrices one at a time."""
    a = _float_batch()
    tol = np.array([0.0, 1e-5, 0.5, 1e-3], np.float32)
    rt = trref.rref_batched(torch.from_numpy(a), tol=torch.from_numpy(tol),
                            pivot_rule="partial")
    for i in range(4):
        one = trref.rref(torch.from_numpy(a[i]), tol=float(tol[i]),
                         pivot_rule="partial")
        for f in rt._fields:
            assert torch.equal(getattr(rt, f)[i], getattr(one, f)), (i, f)


def test_rref_single_and_without_events_matches_jax():
    a = _float_batch()[1]
    rj = jrref.rref(jnp.asarray(a), tol=1e-5, pivot_rule="partial",
                    record_events=False)
    rt = trref.rref(torch.from_numpy(a), tol=1e-5, pivot_rule="partial",
                    record_events=False)
    _assert_agree(jrref.RREFResult(*(x[None] for x in rj)),
                  trref.RREFResult(*(x[None] for x in rt)))
    assert int(rt.num_events) == 0 and int(rt.num_pivots) == 6


def test_rref_refuses_what_the_reference_refuses():
    a = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="pivot rule"):
        trref.rref_batched(a, pivot_rule="rook")
    with pytest.raises(ValueError, match="bar_col"):
        trref.rref_batched(a, bar_col=5)
