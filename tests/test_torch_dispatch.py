"""The port's batched solve as a whole: ``linalg_solver_tpu_torch.ops
.dispatch.solve_batched(backend="auto")`` against the JAX package's
``dispatch.solve_batched(backend="rbt")`` (the fused kernel in interpret
mode plus its rescue), on the same numpy inputs.

The port's default butterfly draw (a torch generator) differs from the
JAX threefry draw, so the two refined solutions agree only to f32
rounding of the solution: rtol 1e-4 per system, and a float64 residual
≤ 1e-5 on every finite system.  Fed the JAX draws, ``ops.rbt
.solve_rbt_batched`` runs the same arithmetic as the JAX fused path and
is held to 1e-5.

Some of its cases live in ``tests/test_torch_dispatch_solve.py`` (files
of at most 11 tests: pytest-xdist's ``--dist loadfile`` queues a file by
its number of tests, and so queues these after the slow JAX file
``tests/test_lu_large.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import dispatch as jdispatch
from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu.ops.pallas import gj_kernel as jgj
from linalg_solver_tpu_torch.ops import dispatch, kernels, lu_blocked
from linalg_solver_tpu_torch.ops import lu_large, rbt
from linalg_solver_tpu_torch.ops.kernels.solve_fused import fits


def _batch(B, N, seed, k=None):
    rng = np.random.RandomState(seed)
    a = (rng.randn(B, N, N) + 4.0 * np.sqrt(N) * np.eye(N)).astype(
        np.float32)
    shape = (B, N) if k is None else (B, N, k)
    return a, rng.randn(*shape).astype(np.float32)


def _resid(a, b, x):
    """Worst relative residual per system, in float64."""
    a64 = a.astype(np.float64)
    b3 = b.reshape(b.shape[0], b.shape[1], -1).astype(np.float64)
    x3 = x.reshape(b3.shape).astype(np.float64)
    r = np.einsum("bij,bjk->bik", a64, x3) - b3
    return np.abs(r).max(axis=(1, 2)) / np.abs(b3).max(axis=(1, 2))


def _jax_diags(n, keys):
    """The JAX package's (U, V) draw for PRNG keys ``keys``, as the
    port's ``[2, n]`` tensors."""
    d = rbt.shrink_depth(n)
    return rbt.diags_from_numpy(*(
        [np.asarray(v) for v in jrbt.rbt_diags(
            jax.random.PRNGKey(key), n, d, jnp.float32)]
        for key in keys
    ))


def _both(a, b):
    xj = np.asarray(jdispatch.solve_batched(
        jnp.asarray(a), jnp.asarray(b), backend="rbt"))
    xt = dispatch.solve_batched(
        torch.from_numpy(a), torch.from_numpy(b), backend="auto").numpy()
    assert xt.shape == xj.shape == b.shape
    return xj, xt


def _assert_close(xj, xt, lanes, rtol=1e-4):
    for i in lanes:
        err = np.max(np.abs(xt[i] - xj[i]))
        assert err <= rtol * np.max(np.abs(xj[i])), (i, err)


def test_nan_system_is_non_finite_and_contained():
    a, b = _batch(5, 64, seed=23)
    a[3, 10, 11] = np.nan
    xj, xt = _both(a, b)
    assert not np.isfinite(xj[3]).all() and not np.isfinite(xt[3]).all()
    keep = [0, 1, 2, 4]
    _assert_close(xj, xt, keep)
    assert _resid(a[keep], b[keep], xt[keep]).max() <= 1e-5


def test_singular_system_is_non_finite():
    """An exactly singular system fails the redraw too and ends in the
    pivoted solve, which returns non-finite values."""
    a, b = _batch(4, 64, seed=31)
    a[2] = 0.0
    xt = dispatch.solve_batched(torch.from_numpy(a), torch.from_numpy(b))
    xt = xt.numpy()
    assert not np.isfinite(xt[2]).all()
    keep = [0, 1, 3]
    assert _resid(a[keep], b[keep], xt[keep]).max() <= 1e-5


@pytest.mark.parametrize("n,k", [(63, None), (7, None), (63, 3)],
                         ids=["n63", "n7", "n63_k3"])
def test_auto_routes_odd_n_to_the_pivoted_kernel(n, k):
    """Odd N: past the fused kernel and the phase engine, ``auto`` takes
    kernel 3 on ``[A | b]`` (the ``"pallas"`` backend), as the reference
    routes N = 63 and N = 7; bitwise as ``ops.kernels.solve_batched``,
    and within 1e-5 of the JAX package's ``ops.pallas.solve_batched``
    (its Gauss–Jordan kernel in interpret mode: the same pivots, the
    plain version's float64 products differ from XLA's fused ones by a
    rounding)."""
    a, b = _batch(3, n, seed=n + 50, k=k)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert dispatch._resolve("auto", n, k or 1, k is None) == "pallas"
    x = dispatch.solve_batched(at, bt)
    assert torch.equal(x, kernels.solve_batched(at, bt))
    assert torch.equal(x, dispatch.solve_batched(at, bt, backend="pallas"))
    xj = np.asarray(jgj.solve_batched(jnp.asarray(a), jnp.asarray(b),
                                      interpret=True))
    _assert_close(xj, x.numpy(), range(3), rtol=1e-5)
    assert _resid(a, b, x.numpy()).max() <= 1e-5


def test_pallas_solve_reach_and_the_even_n_it_takes():
    """``"pallas"`` takes ``[A | b]`` while it fits kernel 3 (N <= 236 at
    k = 1); ``auto`` gives it the even N that the fused kernel (k > 8) and
    the phase engine (N % 8 != 0) refuse, and leaves every route that
    existed where it was."""
    assert kernels.solve_fits(236, 1) and not kernels.solve_fits(237, 1)
    assert dispatch._resolve("auto", 10, 9, False) == "pallas"
    assert dispatch._resolve("auto", 64, 1, True) == "rbt"
    assert dispatch._resolve("auto", 62, 8, False) == "rbt"
    assert dispatch._resolve("auto", 64, 9, False) == "rbt"
    with pytest.raises(ValueError, match="pivoted kernel"):
        dispatch.solve_batched(torch.zeros(1, 236, 236),
                               torch.zeros(1, 236, 4), backend="pallas")


def test_auto_routes_n1088_to_the_library_solve():
    """From N = 1024 with N % 128 != 0 the reference routes ``auto`` to
    ``"xla"`` (``jnp.linalg.solve``); the port to ``torch.linalg.solve``,
    bitwise as called directly, within 1e-4 of ``jnp.linalg.solve`` (two
    partial-pivot LUs in f32, summed in other orders)."""
    n = 1088
    a, b = _batch(1, n, seed=19)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert dispatch._resolve("auto", n, 1, True) == "xla"
    x = dispatch.solve_batched(at, bt)
    assert torch.equal(x, torch.linalg.solve(at, bt[:, :, None])[:, :, 0])
    xj = np.asarray(jnp.linalg.solve(jnp.asarray(a),
                                     jnp.asarray(b)[:, :, None]))[:, :, 0]
    _assert_close(xj, x.numpy(), range(1), rtol=1e-4)
    assert _resid(a, b, x.numpy()).max() <= 1e-5


def test_auto_routes_n1024_to_the_large_solve():
    """N = 1024 with a vector RHS: the large-N RBT solve at nb = 128, as
    the reference's ``"mixed"`` branch routes it, bitwise as called
    directly."""
    a, b = _batch(1, 1024, seed=17)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert dispatch.large_reaches(1024, True)
    x = dispatch.solve_batched(at, bt)
    assert torch.equal(x, lu_large.large_solve_rbt(at, bt, nb=128))
    assert _resid(a, b, x.numpy()).max() <= 1e-5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dispatch.solve_batched(at, bt[:, :, None].expand(1, 1024, 2),
                               backend="mixed")


@pytest.mark.parametrize("n,nb", [(64, 64), (96, 48), (40, 8)])
def test_mixed_backend_is_the_mixed_phase_loop(n, nb):
    """Below 1024, ``"mixed"`` is ``pallas_solve_mixed_batched`` with the
    first of 64, 48, 32, 16, 8 that divides N, bitwise as called
    directly."""
    a, b = _batch(2, n, seed=n)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    x = dispatch.solve_batched(at, bt, backend="mixed")
    assert torch.equal(x, lu_blocked.pallas_solve_mixed_batched(at, bt,
                                                                nb=nb))
    assert _resid(a, b, x.numpy()).max() <= 1e-5
    with pytest.raises(ValueError, match="panel width"):
        dispatch.solve_batched(torch.zeros(1, 30, 30), torch.zeros(1, 30),
                               backend="mixed")


@pytest.mark.parametrize("k", [None, 3], ids=["vector", "matrix"])
def test_blocked_pallas_backend_is_the_phase_loop_solve(k):
    a, b = _batch(2, 128, seed=19, k=k)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    x = dispatch.solve_batched(at, bt, backend="blocked_pallas")
    assert torch.equal(x, lu_blocked.pallas_solve_batched(at, bt, nb=64))
    assert _resid(a, b, x.numpy()).max() <= 1e-5
    with pytest.raises(ValueError, match="min\\(64, N\\)"):
        dispatch.solve_batched(torch.zeros(1, 100, 100), torch.zeros(1, 100),
                               backend="blocked_pallas")


@pytest.mark.parametrize("backend", ["mixed", "blocked_pallas"])
def test_gradient_through_the_pivoted_backends(backend):
    a, b = _batch(2, 32, seed=21)
    w = torch.from_numpy(np.random.RandomState(22).randn(2, 32)).float()
    grads = []
    for solve in (
        lambda at, bt: dispatch.solve_batched(at, bt, backend=backend),
        lambda at, bt: torch.linalg.solve(at, bt.unsqueeze(-1)).squeeze(-1),
    ):
        at = torch.from_numpy(a).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        (solve(at, bt) * w).sum().backward()
        grads.append((at.grad, bt.grad))
    for got, want in zip(grads[0], grads[1]):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def test_kernel_reach_boundary():
    assert fits(794, 1) and not fits(796, 1)
    assert fits(574, 8) and not fits(576, 8)
    assert fits(256, 8) and not fits(256, 9) and not fits(255, 1)


def test_xla_backend_is_the_library_solve():
    a, b = _batch(3, 63, seed=4)
    x = dispatch.solve_batched(
        torch.from_numpy(a), torch.from_numpy(b), backend="xla")
    assert x.shape == b.shape
    assert _resid(a, b, x.numpy()).max() <= 1e-5
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.solve_batched(
            torch.from_numpy(a), torch.from_numpy(b), backend="lapack")
    assert dispatch.BACKENDS == ("auto", "rbt", "mixed", "blocked_pallas",
                                 "blocked", "pallas", "loop", "xla", "dd")


@pytest.mark.parametrize("k", [None, 3], ids=["vector", "matrix"])
def test_gradient_matches_library_autograd(k):
    a, b = _batch(2, 32, seed=5, k=k)
    w = torch.from_numpy(np.random.RandomState(6).randn(*b.shape))
    grads = []
    for solve in (
        lambda at, bt: dispatch.solve_batched(at, bt, backend="auto"),
        lambda at, bt: (
            torch.linalg.solve(at, bt.unsqueeze(-1)).squeeze(-1)
            if k is None else torch.linalg.solve(at, bt)
        ),
    ):
        at = torch.from_numpy(a).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        (solve(at, bt) * w.float()).sum().backward()
        grads.append((at.grad, bt.grad))
    for got, want in zip(grads[0], grads[1]):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-4


def _earlier_solve_route(n, k, vector_rhs):
    """``auto``'s solve routes before the loop backend existed, or None
    where it raised."""
    if fits(n, k) or dispatch.phase_reaches(n):
        return "rbt"
    if dispatch.large_reaches(n, vector_rhs):
        return "mixed"
    if n >= 1024 and n % 128:
        return "xla"
    if kernels.solve_fits(n, k):
        return "pallas"
    return None


def test_auto_keeps_every_earlier_route():
    """Every (N, k) that ``auto`` routed before keeps its route; what
    raised below N = 1024 now takes the loop, as in the reference; a
    matrix RHS from N = 1024 with N % 128 == 0 still raises."""
    for n in range(1, 1300):
        for k in (1, 2, 8, 9, 16):
            vector_rhs = k == 1
            before = _earlier_solve_route(n, k, vector_rhs)
            if before is None and n >= 1024:
                with pytest.raises(NotImplementedError):
                    dispatch._resolve("auto", n, k, vector_rhs)
                continue
            got = dispatch._resolve("auto", n, k, vector_rhs)
            assert got == (before or "loop"), (n, k)
