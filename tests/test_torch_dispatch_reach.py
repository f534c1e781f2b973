"""``auto``'s solve outside the kernels' reach, against the JAX
package's ``"loop"`` backend.  Split from ``tests/test_torch_dispatch.py``,
whose helpers it shares, so that ``--dist loadfile`` runs the two on two
workers: the reference's loop at N = 796 takes minutes on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import dispatch as jdispatch
from linalg_solver_tpu_torch.ops import dispatch
from test_torch_dispatch import _assert_close, _batch, _resid


@pytest.mark.parametrize(
    "n,k", [(796, None), (1024, 16)], ids=["smem_k1", "n1024_k16"],
)
def test_auto_raises_outside_the_kernel_reach(n, k):
    """796 is the smallest even N past the fused kernel's shared memory at
    k=1, and not a multiple of 8, so the phase engine does not take it
    either, nor kernel 3 (N <= 236): ``auto`` ends in the LU loop, as the
    reference's does (``"loop"``), within 1e-5 of the JAX package's loop
    (the same factorization; the substitutions sum in another order).
    From N = 1024 with N % 128 == 0 the large-N solve takes only a vector
    RHS, in the reference too: that still raises."""
    if k is not None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dispatch.solve_batched(torch.zeros(1, n, n),
                                   torch.zeros(1, n, k))
        return
    a, b = _batch(1, n, seed=n)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert dispatch._resolve("auto", n, 1, True) == "loop"
    x = dispatch.solve_batched(at, bt)
    xj = np.asarray(jdispatch.solve_batched(jnp.asarray(a), jnp.asarray(b),
                                            backend="loop"))
    _assert_close(xj, x.numpy(), range(1), rtol=1e-5)
    assert _resid(a, b, x.numpy()).max() <= 1e-5
