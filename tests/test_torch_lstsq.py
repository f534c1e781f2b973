"""The port's least squares, thin QR and basis completion
(``linalg_solver_tpu_torch.ops.lstsq``) against the JAX package's
``ops.lstsq``, fed the same numpy inputs.

Exact: every ``ok`` flag (a rank-deficient lane included: NaN in both)
and NaN where the reference has NaN.  The rank-deficient lane has a zero
column (a zero row when wide): the second Gram pass then meets an exact
zero pivot.  A repeated column leaves that pivot at the noise level
(≈ 1e-11 of the diagonal), and its sign, so the flag, is decided by the
two Cholesky routines' rounding: on one such input the reference's fails
and the library's succeeds, on the reference's own Gram matrix too.
Values: within 1e-5 of the largest entry; ``complete_basis_batched`` on
the reference's own Gaussian block (``jax.random.PRNGKey(7)``), passed
in; each adjoint (least squares, minimum norm, QR) within 1e-4 of
``jax.vjp``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import lstsq as jls
from linalg_solver_tpu_torch.ops import lstsq as tls

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.abs(got[fin] - want[fin]).max() <= rtol * max(
        np.abs(want[fin]).max(), 1.0)


def _system(m, n, k, seed):
    """``[3, m, n]``; lane 1 rank-deficient (a zero column, or row when
    wide)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(3, m, n).astype(np.float32)
    if m >= n:
        a[1, :, n - 2] = 0.0
    else:
        a[1, m - 2] = 0.0
    shape = (3, m) if k is None else (3, m, k)
    return a, rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("m,n,k", [(12, 5, None), (12, 5, 2), (5, 12, None),
                                   (5, 12, 2)])
def test_lstsq_matches_jax(m, n, k):
    a, b = _system(m, n, k, seed=m * 10 + n)
    rj = jls.lstsq_batched(jnp.asarray(a), jnp.asarray(b))
    rt = tls.lstsq_batched(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.tolist() == [True, False, True]
    _close(rt.x, rj.x)
    _close(rt.resid, rj.resid)


def test_qr_matches_jax():
    a, _ = _system(12, 5, None, seed=4)
    rj = jls.qr_batched(jnp.asarray(a))
    rt = tls.qr_batched(torch.from_numpy(a))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    _close(rt.Q, rj.Q)
    _close(rt.R, rj.R)
    with pytest.raises(ValueError, match="m >= n"):
        tls.qr_batched(torch.zeros(1, 3, 4))


def test_complete_basis_matches_jax_on_its_draw():
    rng = np.random.RandomState(5)
    u = np.asarray(jls.qr_batched(jnp.asarray(
        rng.randn(2, 7, 3).astype(np.float32))).Q)
    want = np.asarray(jls.complete_basis_batched(jnp.asarray(u)))
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (7, 4),
                                     jnp.float32))
    got = tls.complete_basis_batched(torch.from_numpy(u), torch.from_numpy(g))
    _close(got, want)
    # the default draw is another one, and still completes the basis
    full = torch.cat([torch.from_numpy(u),
                      tls.complete_basis_batched(torch.from_numpy(u))], dim=2)
    eye = torch.eye(7, dtype=torch.float64)
    assert float((full.double().mT @ full.double() - eye).abs().max()) < 1e-5


def _grads(jf, tf, args, cot):
    _, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(cot) if not isinstance(cot, tuple)
               else tuple(map(jnp.asarray, cot)))
    ts = [torch.tensor(x, requires_grad=True) for x in args]
    outs = tf(*ts)
    cots = cot if isinstance(cot, tuple) else (cot,)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, ts), want


@pytest.mark.parametrize("m,n", [(10, 4), (4, 10)])
def test_lstsq_vjp_matches_jax(m, n):
    rng = np.random.RandomState(m)
    a = rng.randn(3, m, n).astype(np.float32)
    b = rng.randn(3, m).astype(np.float32)
    cot = rng.randn(3, n).astype(np.float32)
    got, want = _grads(lambda x, y: jls.lstsq_batched(x, y).x,
                       lambda x, y: tls.lstsq_batched(x, y).x, (a, b), cot)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4)


def test_qr_vjp_matches_jax():
    rng = np.random.RandomState(8)
    a = rng.randn(3, 10, 4).astype(np.float32)
    cot = (rng.randn(3, 10, 4).astype(np.float32),
           rng.randn(3, 4, 4).astype(np.float32))
    got, want = _grads(lambda x: tuple(jls.qr_batched(x)[:2]),
                       lambda x: tuple(tls.qr_batched(x)[:2]), (a,), cot)
    _close(got[0], want[0], rtol=1e-4)
