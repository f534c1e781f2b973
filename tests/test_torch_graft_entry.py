"""The port's flagship step (``linalg_solver_tpu_torch.graft_entry``)
against the JAX package's ``__graft_entry__.entry()`` forward on the same
numpy inputs: both solve through ``dispatch.solve_batched(backend=
"auto")``, the port on the fused kernel's plain version on the CPU, the
JAX package on its own ``auto`` route there.  Solutions agree to 1e-5 of
each system's largest entry, and both residuals sit at the f32 floor."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from linalg_solver_tpu_torch import graft_entry
from linalg_solver_tpu_torch.ops.kernels import solve_fused


def test_entry_shapes_and_device():
    fn, (a, b) = graft_entry.entry("cpu")
    assert a.shape == (graft_entry.B, graft_entry.N, graft_entry.N) == (
        8, 64, 64)
    assert b.shape == (8, 64) and a.dtype == b.dtype == torch.float32
    assert a.device.type == b.device.type == "cpu"
    fn2, (a2, b2) = graft_entry.entry("cpu")
    assert torch.equal(a, a2) and torch.equal(b, b2)       # seeded
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.entry()


def test_forward_matches_the_jax_entry_on_the_same_inputs():
    import jax.numpy as jnp

    fn_j, (aj, bj) = jentry.entry()
    a, b = np.asarray(aj), np.asarray(bj)
    fn, _ = graft_entry.entry("cpu")
    before = solve_fused.LAUNCHES
    x = fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert solve_fused.LAUNCHES == before        # the plain version on the CPU
    xj = np.asarray(fn_j(jnp.asarray(a), jnp.asarray(b)))
    assert x.shape == xj.shape == (8, 64)
    for i in range(8):
        assert np.abs(x[i] - xj[i]).max() <= 1e-5 * np.abs(xj[i]).max(), i
    r = np.einsum("bij,bj->bi", a.astype(np.float64), x) - b
    assert (np.abs(r).max(axis=1) / np.abs(b).max(axis=1)).max() <= 1e-5
