"""The port's symmetric eigensolver path (``linalg_solver_tpu_torch.ops
.symmetric``) against the JAX package's ``ops.symmetric``, fed the same
numpy inputs.

Exact: ``converged``, ``is_symmetric_batched``.  Values: eigenvalues
within 1e-5 of each matrix's max|A|; eigenvectors compared as spans
(each column up to its sign: the sign is free); the symmetry defect
within 1e-6; ``eigh_batched``'s gradient within 1e-4 of its largest
entry against ``jax.grad`` of the reference, on matrices with a
repeated eigenvalue, where both are finite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import symmetric as jsym
from linalg_solver_tpu_torch.ops import symmetric as tsym


def _sym(B, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, n, n).astype(np.float32)
    return ((x + x.transpose(0, 2, 1)) / 2).astype(np.float32)


def test_eigh_batched_matches_jax():
    a = _sym(3, 7, seed=1)
    a[2] += 1e-3 * np.triu(np.ones((7, 7), np.float32), 1)  # not symmetric
    rj = jsym.eigh_batched(jnp.asarray(a))
    rt = tsym.eigh_batched(torch.from_numpy(a))
    scale = np.abs(a).max(axis=(1, 2))[:, None]
    assert (np.abs(rt.w.numpy() - np.asarray(rj.w)) <= 1e-5 * scale).all()
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    # distinct eigenvalues: each column is the reference's up to sign
    dots = np.abs(np.einsum("bij,bij->bj", rt.V.numpy(), np.asarray(rj.V)))
    assert np.abs(dots - 1.0).max() <= 1e-4


def test_symmetry_probe_matches_jax():
    a = _sym(4, 5, seed=2)
    a[1, 0, 3] += 1e-3
    a[3, 4, 1] += 1e-8
    dj = np.asarray(jsym.symmetry_defect_batched(jnp.asarray(a)))
    dt = tsym.symmetry_defect_batched(torch.from_numpy(a)).numpy()
    assert np.abs(dt - dj).max() <= 1e-6
    np.testing.assert_array_equal(
        tsym.is_symmetric_batched(torch.from_numpy(a)).numpy(),
        np.asarray(jsym.is_symmetric_batched(jnp.asarray(a))))
    assert tsym.is_symmetric_batched(torch.from_numpy(a)).tolist() == [
        True, False, True, True]


def _repeated():
    """Two exactly representable symmetric 4x4 matrices with a repeated
    eigenvalue: ``H diag(w) H`` with the Householder reflection
    ``H = I − ½·11ᵀ`` (entries ±½), eigenvalues (1, 1, 2, 3) and
    (−1, 2, 2, 4)."""
    H = np.eye(4) - 0.5 * np.ones((4, 4))
    P = np.eye(4)[[2, 0, 3, 1]]
    a = np.stack([H @ np.diag([1.0, 1.0, 2.0, 3.0]) @ H,
                  P @ H @ np.diag([-1.0, 2.0, 2.0, 4.0]) @ H @ P.T])
    return a.astype(np.float32)


# loss = Σ_i c_i w_i + Σ_i h_i v_iᵀ C v_i with c and h equal on the
# repeated slots: invariant under the choice of basis in the repeated
# eigenspace, so the two packages' gradients are comparable
_C = np.array([0.5, 0.5, -1.0, 2.0], np.float32)
_H = np.array([1.5, 1.5, 0.25, -0.75], np.float32)
_M = (np.arange(16, dtype=np.float32).reshape(4, 4) % 5 - 2.0) / 3.0
_M = (_M + _M.T) / 2


def test_eigh_gradient_matches_jax_on_repeated_eigenvalues():
    a = _repeated()
    # the repeated slots sit at the same ascending positions in both
    # matrices (0, 1 and 1, 2): order the weights to match
    c = np.stack([_C, _C[[2, 0, 1, 3]]])
    h = np.stack([_H, _H[[2, 0, 1, 3]]])

    def jloss(x):
        r = jsym.eigh_batched(x)
        quad = jnp.einsum("bji,jk,bki->bi", r.V, jnp.asarray(_M), r.V)
        return jnp.sum(jnp.asarray(c) * r.w) + jnp.sum(jnp.asarray(h) * quad)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(a)))

    x = torch.from_numpy(a).requires_grad_()
    r = tsym.eigh_batched(x)
    quad = torch.einsum("bji,jk,bki->bi", r.V, torch.from_numpy(_M), r.V)
    (torch.sum(torch.from_numpy(c) * r.w)
     + torch.sum(torch.from_numpy(h) * quad)).backward()
    gt = x.grad.numpy()
    assert np.isfinite(gj).all() and np.isfinite(gt).all()
    assert np.abs(gt - gj).max() <= 1e-4 * np.abs(gj).max()


@pytest.mark.parametrize("which", ["w", "V"])
def test_unused_output_gets_a_zero_cotangent(which):
    """A loss on one output only: the other's cotangent is zero."""
    a = _sym(2, 5, seed=3)
    x = torch.from_numpy(a).requires_grad_()
    r = tsym.eigh_batched(x)
    getattr(r, which).sum().backward()
    gj = np.asarray(jax.grad(
        lambda y: jnp.sum(getattr(jsym.eigh_batched(y), which)))(
            jnp.asarray(a)))
    if which == "w":   # the sign of V is free; Σ w is not
        assert np.abs(x.grad.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()
    assert bool(torch.isfinite(x.grad).all())
