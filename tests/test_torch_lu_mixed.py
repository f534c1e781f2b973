"""The mixed solve on kernel 6's phase loop (``ops.lu_blocked``,
``"mixed"``) against the JAX package, and its rescue, which takes only the
flagged system.  Split from ``tests/test_torch_lu_blocked_pallas.py``
(its helpers and tolerances)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import lu_blocked as jlub
from linalg_solver_tpu_torch.ops import lu_blocked

from test_torch_lu_blocked_pallas import _batch, _close, _growth_system, _resid


@pytest.mark.parametrize("ir_steps,nbi", [(0, None), (1, None), (2, None),
                                          (2, 4)],
                         ids=["ir0", "ir1", "ir2", "ir2_nbi4"])
def test_pallas_solve_mixed_matches_jax(ir_steps, nbi):
    """``nbi=4``: the two-level panel, 4-wide sub-panels of each 16-wide
    panel through the kernel."""
    a, b = _batch(3, 32, seed=2 + ir_steps)
    xt = lu_blocked.pallas_solve_mixed_batched(
        torch.from_numpy(a), torch.from_numpy(b), nb=16, ir_steps=ir_steps,
        nbi=nbi)
    xj = jlub.pallas_solve_mixed_batched(
        jnp.asarray(a), jnp.asarray(b), nb=16, ir_steps=ir_steps,
        interpret=True, nbi=nbi)
    _close(xt.numpy(), xj)
    assert _resid(a, b, xt.numpy()).max() <= 1e-5


def test_mixed_rescue_takes_only_the_flagged_system():
    """System 1 keeps a large residual after refinement: it and only it
    is solved again by the pivoted rung; the other systems come back
    bitwise as without the fallback."""
    a, b = _batch(3, 64, seed=7)
    a[1] = _growth_system(64)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    x = lu_blocked.pallas_solve_mixed_batched(at, bt, nb=16)
    x0 = lu_blocked.pallas_solve_mixed_batched(at, bt, nb=16, fallback=False)
    assert _resid(a, b, x0.numpy())[1] > 1e-2
    for i in (0, 2):
        assert torch.equal(x[i], x0[i]), i
    assert torch.equal(x[1:2], lu_blocked.blocked_solve_batched(
        at[1:2], bt[1:2], ir_steps=2))
    assert not torch.equal(x[1], x0[1])
    xj = np.asarray(jlub.pallas_solve_mixed_batched(
        jnp.asarray(a), jnp.asarray(b), nb=16, interpret=True))
    _close(x.numpy()[[0, 2]], xj[[0, 2]])
