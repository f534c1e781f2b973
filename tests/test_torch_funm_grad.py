"""The gradient of the port's ``expm_batched`` (an autograd Function whose
backward is the Fréchet derivative at Aᵀ, one block exponential) against
``jax.grad`` of the same loss through the JAX package's custom VJP
(``tests/test_autodiff.py``'s cases): within 1e-4 of the largest entry.
In float64 it passes ``torch.autograd.gradcheck``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import funm as jfm
from linalg_solver_tpu_torch.ops import funm as tfm

TOL = 1e-4


def _grads(a, g, loss):
    ga = jax.grad(lambda x: loss(jfm.expm_batched(x), jnp.asarray(g)))(
        jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)
    loss(tfm.expm_batched(at), torch.from_numpy(g)).backward()
    return at.grad.double().numpy(), np.asarray(ga, np.float64)


@pytest.mark.parametrize("case", ["frechet_adjoint", "large_norm"])
def test_grad_matches_jax(case):
    rng = np.random.RandomState(5 if case == "frechet_adjoint" else 6)
    if case == "frechet_adjoint":
        a = (rng.randn(3, 10, 10) / np.sqrt(10)).astype(np.float32)
        g = rng.randn(3, 10, 10).astype(np.float32)

        def loss(e, w):
            return (w * e).sum()
    else:
        # lanes that square (‖A‖ > θ₁₃): the squaring loop's path
        a = (3.0 * rng.randn(2, 6, 6)).astype(np.float32)
        g = np.ones_like(a)

        def loss(e, w):
            return (w * e ** 2).sum() / 1e6
    got, want = _grads(a, g, loss)
    for b in range(a.shape[0]):
        assert np.abs(got[b] - want[b]).max() <= TOL * max(
            np.abs(want[b]).max(), 1.0)


def test_gradcheck_float64():
    a = torch.from_numpy(
        np.random.RandomState(7).randn(2, 4, 4) * 0.7).requires_grad_(True)
    assert torch.autograd.gradcheck(tfm.expm_batched, (a,), eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_grad_through_the_trigonometric_embedding():
    """cos and sin differentiate through the 2n exponential's backward."""
    rng = np.random.RandomState(8)
    a = (rng.randn(2, 5, 5) / np.sqrt(5)).astype(np.float32)
    ga = jax.grad(lambda x: jnp.sum(jfm.cosm_batched(x) + 2.0
                                    * jfm.sinm_batched(x)))(jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)
    c, s = tfm.cosm_sinm_batched(at)
    (c + 2.0 * s).sum().backward()
    want = np.asarray(ga, np.float64)
    assert np.abs(at.grad.double().numpy() - want).max() <= TOL * max(
        np.abs(want).max(), 1.0)
