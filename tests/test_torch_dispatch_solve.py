"""``dispatch.solve_batched``'s slower cases against the JAX package and the
library: the route past the fused kernel to the phase engine, a matrix
right-hand side, clean systems, the RBT solve on the JAX draws and the
rescue of a zero leading minor.  Split from ``tests/test_torch_dispatch.py``
(its helpers and tolerances)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import dispatch as jdispatch
from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu_torch.ops import dispatch, rbt
from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf
from linalg_solver_tpu_torch.ops.kernels.solve_fused import fits
from linalg_solver_tpu_torch.utils import systems

from test_torch_dispatch import (_assert_close, _batch, _both, _jax_diags,
                                 _resid)


def test_clean_systems():
    a, b = _batch(4, 64, seed=1)
    xj, xt = _both(a, b)
    _assert_close(xj, xt, range(4))
    assert _resid(a, b, xt).max() <= 1e-5


def test_zero_leading_minor_is_rescued():
    """A full-rank system whose leading 16x16 minor is zero: pivot-free
    LU alone meets a zero pivot; the butterfly (with the rescue behind
    it) solves it."""
    a, b = _batch(5, 64, seed=11)
    a[1, :16, :16] = 0.0
    xj, xt = _both(a, b)
    _assert_close(xj, xt, range(5))
    assert _resid(a, b, xt).max() <= 1e-5


def test_matrix_rhs_k4():
    a, b = _batch(3, 64, seed=13, k=4)
    xj, xt = _both(a, b)
    _assert_close(xj, xt, range(3))
    assert _resid(a, b, xt).max() <= 1e-5


@pytest.mark.parametrize("ir_steps", [1, 2])
def test_rbt_with_the_jax_draws_matches_jax(ir_steps):
    """``solve_rbt_batched`` fed the JAX draws (keys 17/29, redraw
    101/103) against the JAX fused path with its rescue, system by system
    to 1e-5.  System 1 is built so that the main draw meets a zero pivot
    and the redraw solves it; system 2 holds a NaN and ends in the
    pivoted solve."""
    n = 64
    a, b = _batch(4, n, seed=41)
    U, V = _jax_diags(n, rbt.MAIN_SEEDS)
    a[1] = systems.pivot_system(torch.from_numpy(a[1]), U, V, 0.0).numpy()
    a[2, 5, 6] = np.nan
    _, bad = sf.solve_fused_rbt(
        torch.from_numpy(a), torch.from_numpy(b), U, V, ir_steps=ir_steps)
    assert bad.tolist() == [False, True, True, False]
    xj = np.asarray(jrbt.pallas_solve_rbt_batched(
        jnp.asarray(a), jnp.asarray(b), ir_steps=ir_steps, interpret=True))
    xt = rbt.solve_rbt_batched(
        torch.from_numpy(a), torch.from_numpy(b), ir_steps=ir_steps,
        diags=(U, V), rescue_diags=_jax_diags(n, rbt.RESCUE_SEEDS),
    ).numpy()
    assert not np.isfinite(xj[2]).all() and not np.isfinite(xt[2]).all()
    keep = [0, 1, 3]
    _assert_close(xj, xt, keep, rtol=1e-5)
    assert _resid(a[keep], b[keep], xt[keep]).max() <= 1e-5


@pytest.mark.parametrize("n,k", [(64, 9), (576, 8)],
                         ids=["k_over_8", "smem_k8"])
def test_auto_routes_past_the_fused_kernel_to_the_phase_engine(n, k):
    """k > 8 columns, and N = 576 past the fused kernel's shared memory at
    k = 8: exactly the phase engine's pass (clean systems, no rescue).  At
    k = 9 the JAX package's ``backend="rbt"`` (its phase engine too, other
    draws) agrees."""
    a, b = _batch(2, n, seed=n + k, k=k)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert not fits(n, k) and dispatch.phase_reaches(n)
    xt = dispatch.solve_batched(at, bt)
    nb = rbt.phase_nb(n, None, rbt.SOLVE_NB_SMALL if n <= 384
                      else rbt.SOLVE_NB_LARGE)
    phases, bad = rbt._solve_core(
        at, bt, rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu"), nb, 2,
        "bfloat16")
    assert not bad.any() and torch.equal(xt, phases)
    assert _resid(a, b, xt.numpy()).max() <= 1e-5
    if k == 9:
        xj = np.asarray(jdispatch.solve_batched(
            jnp.asarray(a), jnp.asarray(b), backend="rbt"))
        _assert_close(xj, xt.numpy(), range(2))
