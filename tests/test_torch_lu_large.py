"""The port's large-N solvers and pivot-free recursive inverse
(``linalg_solver_tpu_torch.ops.lu_large`` / ``lu_recursive``) against the
JAX package's ``ops.lu_large`` / ``ops.lu_recursive``, on the same numpy
inputs, at small sizes.

The JAX ``_bf16_mm`` casts its inputs to bf16 even on the CPU, where the
port's reduced-precision products are full f32: the factors differ by
design, and only the refined solutions are held to 1e-5 of each system's
largest entry.  The recursive inverse has no such product and agrees to
1e-5 as it is; its ``ok`` flags agree exactly.  ``large_solve_rbt`` is
fed the JAX package's butterfly draw (keys 17/29)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import lu_large as jlarge
from linalg_solver_tpu.ops import lu_recursive as jrec
from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu_torch.ops import lu_large, lu_recursive, rbt
from linalg_solver_tpu_torch.ops.kernels import butterfly
from linalg_solver_tpu_torch.utils import systems

RTOL = 1e-5


def _batch(B, n, seed):
    rng = np.random.RandomState(seed)
    a = (rng.randn(B, n, n) + 4.0 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)
    return a, rng.randn(B, n).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i in range(got.shape[0]):
        err = np.abs(got[i] - want[i]).max()
        assert err <= rtol * np.abs(want[i]).max(), (i, err)


def _resid(a, b, x):
    r = np.einsum("bij,bj->bi", a.astype(np.float64), np.asarray(x)) - b
    return np.abs(r).max(axis=1) / np.abs(b).max(axis=1)


def _jax_diags(n):
    d = rbt.shrink_depth(n)
    return rbt.diags_from_numpy(*(
        [np.asarray(v) for v in jrbt.rbt_diags(
            jax.random.PRNGKey(key), n, d, jnp.float32)]
        for key in rbt.MAIN_SEEDS))


def test_recursive_inverse_matches_jax():
    """Matrix 2 has a zero leading 4x4 minor: a leaf pivot is zero and
    both flag it."""
    a, _ = _batch(3, 32, seed=1)
    a[2, :4, :4] = 0.0
    xt, okt = lu_recursive.inverse_nopivot_recursive(torch.from_numpy(a),
                                                     leaf=4)
    xj, okj = jrec.inverse_nopivot_recursive(jnp.asarray(a), leaf=4)
    assert okt.tolist() == np.asarray(okj).tolist() == [True, True, False]
    _close(xt.numpy()[:2], np.asarray(xj)[:2])
    eye = np.eye(32)
    r = np.einsum("bij,bjk->bik", a[:2].astype(np.float64), xt.numpy()[:2])
    assert np.abs(r - eye).max() <= 5e-5


def test_large_solve_mixed_matches_jax():
    a, b = _batch(2, 64, seed=2)
    xt = lu_large.large_solve_mixed(torch.from_numpy(a), torch.from_numpy(b),
                                    nb=16, ir_steps=2)
    xj = jlarge.large_solve_mixed(jnp.asarray(a), jnp.asarray(b), nb=16,
                                  ir_steps=2)
    _close(xt.numpy(), xj)
    assert _resid(a, b, xt.numpy()).max() <= 1e-5


def test_pivots_to_perm_applies_the_swaps_in_order():
    piv = torch.tensor([[3, 3, 3], [1, 2, 3]], dtype=torch.int32)
    assert lu_large._pivots_to_perm(piv, 4).tolist() == [[2, 0, 1, 3],
                                                         [0, 1, 2, 3]]


@pytest.mark.parametrize("ir_steps", [1, 2])
def test_large_solve_rbt_matches_jax(ir_steps):
    """System 1 is built so that the butterflied matrix's first pivot is
    zero up to rounding (~1e-7).  With two refinement rounds both gates
    flag its residual and both packages rescue it with the pivoted
    ``large_solve_mixed``; with one round the gate (the correction test
    only) passes it in both, off by ~2e-3 (and the two packages' errors
    differ, their factors being rounded differently).  The other systems
    pass."""
    n = 64
    a, b = _batch(3, n, seed=3 + ir_steps)
    U, V = _jax_diags(n)
    a[1] = systems.pivot_system(torch.from_numpy(a[1]), U, V, 0.0).numpy()
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    before = butterfly.LAUNCHES
    xt = lu_large.large_solve_rbt(at, bt, nb=16, ir_steps=ir_steps,
                                  diags=(U, V))
    assert butterfly.LAUNCHES == before           # CPU: the plain version
    xj = jlarge.large_solve_rbt(jnp.asarray(a), jnp.asarray(b), nb=16,
                                ir_steps=ir_steps, interpret=True)
    rescued = ir_steps == 2
    keep = [0, 1, 2] if rescued else [0, 2]
    _close(xt.numpy()[keep], np.asarray(xj)[keep])
    x0 = lu_large.large_solve_rbt(at, bt, nb=16, ir_steps=ir_steps,
                                  diags=(U, V), fallback=False)
    r, r0 = _resid(a, b, xt.numpy()), _resid(a, b, x0.numpy())
    assert r[[0, 2]].max() <= 1e-5 and r0[1] > 1e-4
    assert torch.equal(x0[[0, 2]], xt[[0, 2]])
    if rescued:
        assert r[1] <= 1e-5
    else:
        assert torch.equal(x0, xt) and _resid(a, b, xj)[1] > 1e-4


def test_large_solve_rbt_default_draw_solves():
    """The port's own seeded draw (not the JAX one): same contract."""
    a, b = _batch(2, 128, seed=5)
    x = lu_large.large_solve_rbt(torch.from_numpy(a), torch.from_numpy(b),
                                 nb=32)
    assert _resid(a, b, x.numpy()).max() <= 1e-5
    with pytest.raises(ValueError, match="divisible"):
        lu_large.large_solve_rbt(torch.from_numpy(a), torch.from_numpy(b),
                                 nb=48)
