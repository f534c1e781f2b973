"""The port's parallel cyclic reduction (``ops.tridiag``) against the JAX
package's on the same seeded systems: values to 2e-6 relative (a few f32
roundings of a log₂ n-step elimination on diagonally dominant systems)
and equal ``ok`` flags, a lane with a zero pivot flagged in both."""

import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops.tridiag import tridiag_solve_batched as jsolve
from linalg_solver_tpu_torch.ops.tridiag import tridiag_solve_batched

RTOL = 2e-6


def _systems(B, n, k, seed):
    """Diagonally dominant systems as ``examples/solver_family.py`` builds
    them, with a vector (k = None) or a [B, n, k] right-hand side."""
    rng = np.random.RandomState(seed)
    dl = rng.randn(B, n).astype(np.float32)
    du = rng.randn(B, n).astype(np.float32)
    d = (np.abs(dl) + np.abs(du) + 1).astype(np.float32)
    b = rng.randn(*((B, n) if k is None else (B, n, k))).astype(np.float32)
    return dl, d, du, b


@pytest.mark.parametrize("n, k", [(24, None), (33, 3)])
def test_pcr_matches_the_jax_package(n, k):
    dl, d, du, b = _systems(4, n, k, seed=n)
    d[2, n // 2] = 0.0            # one zero diagonal entry
    d[3] = 0.0                    # every pivot zero: the lane fails
    dl[3] = 0.0
    want = jsolve(dl, d, du, b)
    got = tridiag_solve_batched(*map(torch.from_numpy, (dl, d, du, b)))
    ok = np.asarray(want.ok)
    assert np.array_equal(got.ok.numpy(), ok)
    assert not ok[3] and ok[:2].all()
    wx = np.asarray(want.x)
    scale = np.abs(wx[ok]).max()
    assert np.abs(got.x.numpy()[ok] - wx[ok]).max() <= RTOL * scale
    # the residual of two clean lanes, in float64
    for lane in range(2):
        T = (np.diag(d[lane].astype(np.float64))
             + np.diag(dl[lane, 1:].astype(np.float64), -1)
             + np.diag(du[lane, :-1].astype(np.float64), 1))
        x = got.x[lane].numpy().astype(np.float64)
        r = T @ x - b[lane]
        assert np.abs(r).max() <= 1e-5 * np.abs(b[lane]).max()
