"""The phase engine's inverse (``linalg_solver_tpu_torch.ops.rbt``,
``engine="kernel"``) against the JAX package on the same numpy inputs:
the JAX side in interpret mode with ``factor_precision="float32"``, the
port on its plain versions fed the JAX butterfly draws.  Split from
``tests/test_torch_rbt_phases.py`` (its helpers and tolerance), so that
pytest-xdist's ``--dist loadfile`` queues the two halves apart."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu_torch.ops import rbt

from test_torch_rbt_phases import _assert_close, _jax_diags, _probe_batch


@pytest.mark.parametrize(
    "n,nb,ns_steps",
    [(32, 16, 0), (32, 16, 1), (32, 16, 2), (32, 32, 1),
     (64, 32, 0), (64, 32, 1), (64, 32, 2), (64, 16, 1)],
)
def test_phase_inverse_matches_jax(n, nb, ns_steps):
    """nb = n is the reference's single-phase branch (``m == 1``)."""
    a, _ = _probe_batch(4, n, seed=n + nb + ns_steps)
    draw = _jax_diags(n, rbt.MAIN_SEEDS)
    at = torch.from_numpy(a)

    _, bad = rbt._inverse_core(at, draw, nb, ns_steps, "float32")
    _, bad_j = jrbt._inverse_core(jnp.asarray(a), nb, ns_steps, "float32",
                                  2, rbt.MAIN_SEEDS, True, 8, True)
    assert bad.tolist() == np.asarray(bad_j).tolist()
    assert bad.tolist() == [False, True, False, True]

    xt = rbt.inverse_rbt_batched(
        at, nb=nb, ns_steps=ns_steps, diags=draw,
        rescue_diags=_jax_diags(n, rbt.RESCUE_SEEDS)).numpy()
    xj = np.asarray(jrbt.pallas_inverse_rbt_batched(
        jnp.asarray(a), nb=nb, ns_steps=ns_steps, interpret=True))
    # the zero matrix ends in the pivoted Gauss-Jordan inverse on both
    np.testing.assert_array_equal(xt[3], xj[3])
    eye = np.eye(n)
    r = np.abs(np.einsum("bij,bjk->bik", a[:3].astype(np.float64),
                         xt[:3].astype(np.float64)) - eye).max(axis=(1, 2))
    if ns_steps:
        _assert_close(xt, xj, [0, 1, 2])
        assert r.max() <= 5e-5
        return
    # Unrefined, the redraw's inverse of matrix 1 is off the float64
    # inverse by up to ~2e-4 in either package (the growth of the
    # pivot-free factorization under that draw), so there the two are
    # held to that, not to each other.
    _assert_close(xt, xj, [0, 2])
    x64 = np.linalg.inv(a[1].astype(np.float64))
    for x in (xt[1], xj[1]):
        assert np.abs(x - x64).max() <= 1e-3 * np.abs(x64).max()
    assert r.max() <= 1e-3
