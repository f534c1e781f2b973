"""The port's fused RBT solve (``linalg_solver_tpu_torch.ops.kernels
.solve_fused``) against the JAX package's Pallas kernel in interpret
mode, fed the same numpy inputs and the JAX draw of the butterfly
diagonals (keys 17/29).  On the CPU the port runs its plain version;
``test_torch_cuda.py`` holds the CUDA kernel against it on a card.

Tolerance: per system, max|Δx| ≤ 1e-5·max|x_jax|.  Both sides run the
same f32 operations in the same order except the refinement residual's
dot products (a matmul here, an elementwise sum in the TPU kernel), so
they agree to a few f32 roundings of the well-conditioned refined
solution; 1e-5 leaves a margin of ~20 over what is observed."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu.ops.pallas.solve_fused_kernel import (
    solve_fused_rbt as jax_solve_fused_rbt,
)
from linalg_solver_tpu_torch.ops import rbt
from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf


def _batch(B, N, seed=0):
    rng = np.random.RandomState(seed)
    a = (rng.randn(B, N, N) + 4.0 * np.sqrt(N) * np.eye(N)).astype(
        np.float32)
    b = rng.randn(B, N).astype(np.float32)
    return a, b


def _jax_diags(N, keys=(17, 29)):
    d = rbt.shrink_depth(N)
    levels = [
        [np.asarray(v) for v in jrbt.rbt_diags(
            jax.random.PRNGKey(k), N, d, jnp.float32)]
        for k in keys
    ]
    return rbt.diags_from_numpy(*levels)


def _both(a, b, ir_steps=2, nb=32):
    xj, bj = jax_solve_fused_rbt(
        jnp.asarray(a), jnp.asarray(b), ir_steps=ir_steps, nb=nb,
        interpret=True,
    )
    U, V = _jax_diags(a.shape[-1])
    xt, bt = sf.solve_fused_rbt(
        torch.from_numpy(a), torch.from_numpy(b), U, V, ir_steps=ir_steps
    )
    return np.asarray(xj), np.asarray(bj), xt.numpy(), bt.numpy()


def _assert_agree(xj, bj, xt, bt, rtol=1e-5):
    np.testing.assert_array_equal(bt, bj)
    assert xt.shape == xj.shape and xt.dtype == np.float32
    for i in range(xj.shape[0]):
        fj, ft = np.isfinite(xj[i]), np.isfinite(xt[i])
        np.testing.assert_array_equal(ft, fj, err_msg=f"system {i}")
        if fj.any():
            err = np.max(np.abs(xt[i][fj] - xj[i][fj]))
            scale = np.max(np.abs(xj[i][fj]))
            assert err <= rtol * scale, (i, err, scale)


def _resid(a, b, x):
    a64 = a.astype(np.float64)
    r = np.einsum("bij,bj->bi", a64, x.astype(np.float64)) - b
    return np.linalg.norm(r, axis=1) / np.linalg.norm(b, axis=1)


@pytest.mark.parametrize("N", [64, 96])
def test_matches_jax_and_oracle(N):
    a, b = _batch(6, N, seed=N)
    xj, bj, xt, bt = _both(a, b)
    _assert_agree(xj, bj, xt, bt)
    assert _resid(a, b, xt).max() < 1e-5
    assert not bt.any()


def test_ir0_loose_gate():
    a, b = _batch(4, 64, seed=7)
    xj, bj, xt, bt = _both(a, b, ir_steps=0)
    _assert_agree(xj, bj, xt, bt)
    assert _resid(a, b, xt).max() < 1e-4
    assert not bt.any()


def test_singular_lane_flagged():
    a, b = _batch(4, 64, seed=3)
    a[2] = 0.0
    xj, bj, xt, bt = _both(a, b)
    _assert_agree(xj, bj, xt, bt)
    assert bt.tolist() == [False, False, True, False]
    assert _resid(a, b, xt)[[0, 1, 3]].max() < 1e-5


def test_nan_lane_flagged_and_contained():
    a, b = _batch(5, 64, seed=23)
    a[3, 10, 11] = np.nan
    xj, bj, xt, bt = _both(a, b)
    _assert_agree(xj, bj, xt, bt)
    assert bt.tolist() == [False, False, False, True, False]
    assert not np.isfinite(xt[3]).all()
    assert _resid(a, b, xt)[[0, 1, 2, 4]].max() < 1e-5


@pytest.mark.parametrize("k", [2, 8])
def test_matrix_rhs(k):
    a, _ = _batch(3, 64, seed=13)
    bm = np.random.RandomState(13 + k).randn(3, 64, k).astype(np.float32)
    xj, bj, xt, bt = _both(a, bm)
    assert xt.shape == (3, 64, k)
    _assert_agree(xj, bj, xt, bt)
    want = np.linalg.solve(a.astype(np.float64), bm.astype(np.float64))
    assert np.max(np.abs(xt - want)) < 1e-5


def test_n100_not_a_multiple_of_the_panel():
    """N=100 leaves a 4-column last panel in the CUDA kernel; the JAX
    kernel needs N % nb == 0, so it runs with nb=50 (nb changes only its
    masking, not the math)."""
    a, b = _batch(3, 100, seed=100)
    xj, bj, xt, bt = _both(a, b, nb=50)
    _assert_agree(xj, bj, xt, bt)
    assert _resid(a, b, xt).max() < 1e-5


def test_depth_one_when_half_n_is_odd():
    """N=98: N/2 is odd, so the butterfly shrinks to depth 1 and the
    padded level of the diagonals is never read."""
    a, b = _batch(2, 98, seed=98)
    U, V = _jax_diags(98)
    assert torch.equal(U[1], torch.ones(98))
    U2, V2 = U.clone(), V.clone()
    U2[1], V2[1] = 7.0, -3.0
    x1, b1 = sf.solve_fused_rbt(torch.from_numpy(a), torch.from_numpy(b),
                                U, V)
    x2, b2 = sf.solve_fused_rbt(torch.from_numpy(a), torch.from_numpy(b),
                                U2, V2)
    assert torch.equal(x1, x2) and torch.equal(b1, b2)
    assert _resid(a, b, x1.numpy()).max() < 1e-5


def test_wrapper_rejects_unsupported_shapes():
    U, V = _jax_diags(64)
    a = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="even"):
        sf.solve_fused_rbt(torch.zeros(2, 63, 63), torch.zeros(2, 63), U, V)
    with pytest.raises(ValueError, match="RHS columns"):
        sf.solve_fused_rbt(a, torch.zeros(2, 64, sf.MAX_K_RHS + 1), U, V)
    with pytest.raises(ValueError, match="b must be"):
        sf.solve_fused_rbt(a, torch.zeros(3, 64), U, V)


def test_cpu_path_does_not_count_launches():
    a, b = _batch(2, 64, seed=1)
    U, V = _jax_diags(64)
    before = sf.LAUNCHES
    sf.solve_fused_rbt(torch.from_numpy(a), torch.from_numpy(b), U, V)
    assert sf.LAUNCHES == before
