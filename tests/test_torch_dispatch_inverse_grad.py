"""The determinant's gradient through ``auto`` near the kernels' reach,
against the JAX package.  Split from
``tests/test_torch_dispatch_inverse.py`` so that ``--dist loadfile``
runs the two on two workers: the reference's loop backward at N = 170
and 237 takes minutes on the CPU under load."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import dispatch as jdispatch
from linalg_solver_tpu_torch.ops import dispatch


@pytest.mark.parametrize("n", [170, 237])
def test_auto_det_with_a_gradient_raises_where_the_inverse_stops(n):
    """det reaches N = 237 on kernel 3, but its backward needs the
    inverse, which past 167 takes only multiples of 4 to 180 and of 8
    beyond: there the backward now takes the Gauss–Jordan loop, as the
    reference's does, and no longer raises.  The gradient (Jacobi's
    formula) agrees with the JAX package's ``"loop"`` backend within
    1e-4 of its largest entry (the forward sums the log of 170 or 237
    pivots in another order)."""
    rng = np.random.RandomState(n)
    a = (np.eye(n) + 0.1 * rng.randn(1, n, n) / np.sqrt(n)).astype(
        np.float32)
    assert dispatch._resolve_facade("auto", "det", n) == "pallas"
    assert dispatch._resolve_facade("auto", "inverse", n) == "loop"
    at = torch.from_numpy(a).requires_grad_()
    dispatch.det_batched(at).sum().backward()
    gj_ = np.asarray(jax.grad(lambda x: jdispatch.det_batched(
        x, backend="loop").sum())(jnp.asarray(a)))
    assert np.abs(at.grad.numpy() - gj_).max() <= 1e-4 * np.abs(gj_).max()
    assert dispatch.det_batched(torch.eye(n)[None]).tolist() == [1.0]


def test_auto_det_gradient_at_168_takes_the_phase_inverse():
    """At the first multiple of 8 past the kernels' inverse (N = 184 since
    kernel 2 reaches 180; 168 before) the det's backward takes the phase
    inverse.  ``backend="pallas"`` keeps to the kernels: there a gradient
    still raises before the forward."""
    n = 184
    rng = np.random.RandomState(12)
    a = (np.eye(n) + 0.1 * rng.randn(2, n, n) / np.sqrt(n)).astype(
        np.float32)
    grads = []
    for det in (dispatch.det_batched, torch.linalg.det):
        at = torch.from_numpy(a).requires_grad_()
        (det(at) * torch.tensor([1.0, -0.5])).sum().backward()
        grads.append(at.grad)
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(err) <= 1e-4
    with pytest.raises(ValueError, match="gradient"):
        dispatch.det_batched(torch.from_numpy(a).requires_grad_(), "pallas")


@pytest.mark.parametrize("n", [168, 172, 176, 180])
def test_auto_det_gradient_to_180_inverts_through_kernel_2(n):
    """The det's backward inverts A through kernel 2 up to N = 180, where
    it raised at 172 and 180 before; ``"pallas"`` takes it too."""
    rng = np.random.RandomState(n + 1)
    a = (np.eye(n) + 0.1 * rng.randn(2, n, n) / np.sqrt(n)).astype(
        np.float32)
    grads = []
    for det in (dispatch.det_batched,
                lambda t: dispatch.det_batched(t, "pallas"),
                torch.linalg.det):
        at = torch.from_numpy(a).requires_grad_()
        (det(at) * torch.tensor([1.0, -0.5])).sum().backward()
        grads.append(at.grad)
    for got in grads[:2]:
        err = (got - grads[2]).abs().max() / grads[2].abs().max()
        assert float(err) <= 1e-4
