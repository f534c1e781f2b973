"""``auto``'s inverse, det and rank past the kernels' shared memory,
against the JAX package's ``"loop"`` backend.  Split from
``tests/test_torch_dispatch_inverse.py``, whose helpers it shares, so
that ``--dist loadfile`` runs the two on two workers: each case runs the
reference's loop of n steps, minutes on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import dispatch as jdispatch
from linalg_solver_tpu_torch.ops import dispatch, kernels
from test_torch_dispatch_inverse import _batch, _det_batch, _resid


@pytest.mark.parametrize(
    "op,n",
    [("inverse", 169), ("inverse", 170), ("det", 238), ("rank", 238)],
)
def test_auto_raises_past_the_kernels_reach(op, n):
    """Past the kernels' shared memory ``auto`` now ends as the
    reference's does.  169 is the first N past the pivoted inverse's
    shared memory, and 169 and 170 are no multiples of 8 (the phase
    inverse) or 4 (kernel 2): the Gauss–Jordan loop with ``tol = 1e-30``
    (``"loop"``).  238 is past the pivoted [N, N] tile's shared memory
    and no multiple of 64 (the blocked det): the LU loop.  The rank at
    238 takes kernel 3 in its big reach (here its plain version).  Each
    against the JAX package's ``"loop"`` backend at B = 1: values within
    1e-5 (1e-4 for the inverse, whose entries carry the f32 rounding of
    A⁻¹'s condition), the rank exactly."""
    a = _batch(1, n, seed=n) if op == "inverse" else _det_batch(1, n, seed=n)
    if op == "rank":
        a[0, 5] = 2 * a[0, 1]
        a[0, 9] = 0.0
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    fn = {"inverse": dispatch.inverse_batched, "det": dispatch.det_batched,
          "rank": dispatch.rank_batched}[op]
    jfn = {"inverse": jdispatch.inverse_batched,
           "det": jdispatch.det_batched,
           "rank": jdispatch.rank_batched}[op]
    if op == "rank":
        assert kernels.supports("rank", n)
    else:
        assert dispatch._resolve_facade("auto", op, n) == "loop"
    got = fn(at)
    if op == "rank":
        assert torch.equal(got, kernels.rank_batched(at))
    want = np.asarray(jfn(aj, backend="loop"))
    if op == "rank":
        assert got.tolist() == want.tolist() == [n - 2]
    elif op == "det":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        assert _resid(a, got.numpy()).max() <= 5e-5
