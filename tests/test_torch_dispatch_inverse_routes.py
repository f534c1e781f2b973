"""``dispatch.inverse_batched``'s and ``det_batched``'s slower routes: kernel 2
to N = 180, the library at N = 1024, the blocked and loop backends
against the JAX package, and the blocked phase loop's det and its
gradient at N = 256.  Split from ``tests/test_torch_dispatch_inverse.py``
(its helpers and tolerances)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import dispatch as jdispatch
from linalg_solver_tpu_torch.ops import dispatch, lu_blocked
from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
from linalg_solver_tpu_torch.ops.kernels import inv_rbt

from test_torch_dispatch_inverse import (_batch, _det_batch,
                                         _jax_facade_inverse, _resid)


@pytest.mark.parametrize("op", ["inverse", "det"])
def test_auto_inverse_and_det_at_1024_take_the_library(op):
    """From N = 1024 the reference routes the inverse and the det to
    ``"xla"`` (``jnp.linalg``); the port to ``torch.linalg``, bitwise as
    called directly, and within 1e-4 (inverse, of its largest entry) or
    1e-3 (det, a product of 1024 pivots) of ``jnp.linalg``.  The det's
    input is I + G/(2 sqrt N), whose determinant stays inside f32's
    range."""
    n = 1024
    if op == "inverse":
        a = _batch(1, n, seed=16)
        fn, lib, jfn = dispatch.inverse_batched, torch.linalg.inv, \
            jnp.linalg.inv
    else:
        a = _det_batch(1, n, seed=16)
        fn, lib, jfn = dispatch.det_batched, torch.linalg.det, jnp.linalg.det
    at = torch.from_numpy(a)
    assert dispatch._resolve_facade("auto", op, n) == "xla"
    got = fn(at)
    assert torch.equal(got, lib(at))
    want = np.asarray(jfn(jnp.asarray(a)))
    if op == "inverse":
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        assert _resid(a, got.numpy()).max() <= 5e-5
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)


@pytest.mark.parametrize("n", [168, 172, 176, 180])
def test_auto_inverse_to_180_takes_kernel_2(n):
    """From N = 168 to 180 at N % 4 = 0 ``auto`` takes kernel 2, as the
    reference's takes ``inv_rbt_kernel``: bitwise its wrapper's result,
    within the draws' 1e-4 of the JAX kernel (interpret mode), and a
    float64 residual of 5e-5."""
    a = _batch(2, n, seed=n)
    at = torch.from_numpy(a)
    assert dispatch._resolve_facade("auto", "inverse", n) == "pallas"
    assert inv_rbt.fits(n) and not gj.fits(n, 2 * n)
    x = dispatch.inverse_batched(at)
    assert torch.equal(x, inv_rbt.inverse_rbt_fused_batched(at))
    xj = _jax_facade_inverse(a)
    for i in range(2):
        err = np.abs(x[i].numpy() - xj[i]).max()
        assert err <= 1e-4 * np.abs(xj[i]).max(), (i, err)
    assert _resid(a, x.numpy()).max() <= 5e-5


def test_auto_det_at_256_takes_the_blocked_phase_loop():
    """256 is past the pivoted [N, N] tile (237): ``pallas_det_batched``
    with nb = 64, bitwise as called directly; a singular matrix gives 0
    and a row swap flips the sign."""
    a = _det_batch(3, 256, seed=13)
    a[1] = 0.0
    a[2, [3, 9]] = a[2, [9, 3]]
    at = torch.from_numpy(a)
    d = dispatch.det_batched(at)
    assert torch.equal(d, lu_blocked.pallas_det_batched(at, nb=64))
    want = np.linalg.det(a.astype(np.float64))
    assert float(d[1]) == 0.0 and np.sign(float(d[2])) == np.sign(want[2])
    np.testing.assert_allclose(d.numpy()[[0, 2]], want[[0, 2]], rtol=1e-4)


def test_auto_det_gradient_at_256():
    """The backward inverts through the phase inverse (N % 8 == 0)."""
    a = _det_batch(2, 256, seed=14)
    grads = []
    for det in (dispatch.det_batched, torch.linalg.det):
        at = torch.from_numpy(a).requires_grad_()
        (det(at) * torch.tensor([1.0, -0.5])).sum().backward()
        grads.append(at.grad)
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(err) <= 1e-4


def test_blocked_and_loop_backends_match_jax():
    """The reference's ``"blocked"`` (XLA panels: here the library's LU
    with its diagonal-block inverses) and ``"loop"`` backends at N = 16,
    against the JAX package's same backends, and ``"dd"``'s solve and
    inverse against the JAX package's."""
    n = 16
    a = _batch(2, n, seed=5)
    at, aj = torch.from_numpy(a), jnp.asarray(a)
    b = np.random.RandomState(6).randn(2, n).astype(np.float32)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    for be in ("blocked", "loop"):
        x = dispatch.solve_batched(at, bt, backend=be).numpy()
        xj = np.asarray(jdispatch.solve_batched(aj, bj, backend=be))
        assert np.abs(x - xj).max() <= 1e-5 * np.abs(xj).max(), be
        d = dispatch.det_batched(at, backend=be).numpy()
        np.testing.assert_allclose(
            d, np.asarray(jdispatch.det_batched(aj, backend=be)), rtol=1e-5)
        xi = dispatch.inverse_batched(at, backend=be)
        assert torch.equal(xi, dispatch.inverse_batched(at, backend="loop"))
        assert _resid(a, xi.numpy()).max() <= 5e-5
    res = dispatch.lu_factor_batched(at, backend="blocked")
    rj = jdispatch.lu_factor_batched(aj, backend="blocked")
    for f in ("perm", "sign", "ok"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    assert np.abs(res.lu.numpy() - np.asarray(rj.lu)).max() <= 1e-5 * \
        np.abs(np.asarray(rj.lu)).max()
    x = lu_blocked.blocked_lu_solve(res, bt)
    assert np.abs(x.numpy() - np.asarray(jdispatch.solve_batched(
        aj, bj, backend="loop"))).max() <= 1e-4 * np.abs(x.numpy()).max()
    # "dd": the f64-class solve and inverse collapsed to f32, as the JAX
    # package's (within 1e-6 of the largest entry: both refine to ~1e-13,
    # the collapse to f32 rounds)
    x = dispatch.solve_batched(at, bt, backend="dd").numpy()
    xj = np.asarray(jdispatch.solve_batched(aj, bj, backend="dd"))
    assert np.abs(x - xj).max() <= 1e-6 * np.abs(xj).max()
    xi = dispatch.inverse_batched(at, backend="dd").numpy()
    xij = np.asarray(jdispatch.inverse_batched(aj, backend="dd"))
    assert np.abs(xi - xij).max() <= 1e-6 * np.abs(xij).max()
