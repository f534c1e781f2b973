"""The port's batched inverse, determinant and rank as a whole:
``linalg_solver_tpu_torch.ops.dispatch`` with ``backend="auto"`` against
the JAX package's ``ops.pallas`` facade, its kernels run in interpret
mode (``inverse_rbt_fused_batched`` where ``inv_rbt_kernel.supported``,
else ``gj_kernel``), on the same numpy inputs.

The port's default draws (torch generators) differ from the JAX
threefry draws, so the two inverses agree to f32 rounding of the
inverse: 1e-4 of its largest entry, and a float64 residual
``max|A X − I| ≤ 5e-5``.  The pivoted kernel's results (det, rank, the
inverse at N % 4 ≠ 0) need no draw and agree to 1e-5.

Some of its cases live in
``tests/test_torch_dispatch_inverse_routes.py`` (files of at most 11
tests: pytest-xdist's ``--dist loadfile`` queues a file by its number of
tests, and so queues these after the slow JAX file
``tests/test_lu_large.py``)."""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import dispatch as jdispatch
from linalg_solver_tpu.ops.pallas import gj_kernel as jgj
from linalg_solver_tpu.ops.pallas import inv_rbt_kernel as jinv
from linalg_solver_tpu_torch.ops import dispatch, kernels, lu_blocked, rbt
from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
from linalg_solver_tpu_torch.ops.kernels import inv_rbt


def _batch(B, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, n) + 4.0 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)


def _jax_facade_inverse(a):
    if jinv.supported(a.shape[-1]):
        return np.asarray(jinv.inverse_rbt_fused_batched(
            jnp.asarray(a), interpret=True))
    return np.asarray(jgj.inverse_batched(jnp.asarray(a), interpret=True))


def _resid(a, x):
    n = a.shape[-1]
    r = np.einsum("bij,bjk->bik", a.astype(np.float64),
                  x.astype(np.float64)) - np.eye(n)
    return np.abs(r).max(axis=(1, 2))


@pytest.mark.parametrize("n,rtol", [(64, 1e-4), (32, 1e-4), (30, 1e-5)],
                         ids=["rbt64", "rbt32", "pivoted30"])
def test_inverse_auto_matches_jax_facade(n, rtol):
    a = _batch(6, n, seed=n)
    a[2, : n // 4, : n // 4] = 0.0      # the butterfly (or pivoting) needed
    before = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    xt = dispatch.inverse_batched(torch.from_numpy(a)).numpy()
    assert (inv_rbt.LAUNCHES, gj.LAUNCHES) == before   # CPU: plain versions
    xj = _jax_facade_inverse(a)
    assert xt.shape == a.shape and xt.dtype == np.float32
    for i in range(6):
        err = np.abs(xt[i] - xj[i]).max()
        assert err <= rtol * np.abs(xj[i]).max(), (i, err)
    r = _resid(a, xt)
    assert r[[0, 1, 3, 4, 5]].max() <= 5e-5
    # growth under the butterfly and no refinement: the probe's own
    # bound (the JAX tests hold such matrices to 1e-2 as well)
    assert r[2] <= 1e-2


def test_inverse_singular_matrix_is_contained():
    """A singular matrix comes back as garbage; the others are exact."""
    a = _batch(4, 16, seed=3)
    a[1] = 0.0
    xt = dispatch.inverse_batched(torch.from_numpy(a)).numpy()
    keep = [0, 2, 3]
    assert _resid(a[keep], xt[keep]).max() <= 5e-5


@pytest.mark.parametrize("n", [16, 63])
def test_det_auto_matches_jax_facade(n):
    rng = np.random.RandomState(n)
    a = (np.eye(n) + 0.1 * rng.randn(4, n, n) / np.sqrt(n)).astype(
        np.float32)
    a[3, [0, 1]] = a[3, [1, 0]]
    dj = np.asarray(jgj.det_batched(jnp.asarray(a), interpret=True))
    dt = dispatch.det_batched(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    assert dt[3] < 0


def test_rank_auto_matches_jax_facade():
    rng = np.random.RandomState(7)
    low = np.einsum("bik,bkj->bij", rng.randn(2, 12, 4), rng.randn(2, 4, 9))
    a = np.concatenate([low, rng.randn(2, 12, 9)]).astype(np.float32)
    rj = np.asarray(jgj.rank_batched(jnp.asarray(a), interpret=True))
    rt = dispatch.rank_batched(torch.from_numpy(a))
    assert rt.dtype == torch.int32
    assert rt.tolist() == rj.tolist() == [4, 4, 9, 9]
    tol = torch.full((4,), 1e3)
    assert dispatch.rank_batched(torch.from_numpy(a), tol=tol).tolist() \
        == [0, 0, 0, 0]


@pytest.mark.parametrize("n", [184, 256])
def test_auto_inverse_past_the_kernels_takes_the_phase_engine(n):
    """184 is the first multiple of 8 past the small-N kernels (kernel 2
    stops at 180, the reference's reach): the phase inverse
    (``rbt.inverse_rbt_batched``, panel width 8 there, 64 at 256),
    bitwise as called directly."""
    a = torch.from_numpy(_batch(2, n, seed=n))
    assert not gj.fits(n, 2 * n) and not inv_rbt.fits(n)
    x = dispatch.inverse_batched(a)
    assert torch.equal(x, rbt.inverse_rbt_batched(a))
    assert _resid(a.numpy(), x.numpy()).max() <= 5e-5


def _det_batch(B, n, seed):
    """I + G/(2√n): a determinant of order one, inside f32's range."""
    rng = np.random.RandomState(seed)
    return (np.eye(n) + rng.randn(B, n, n) / (2 * np.sqrt(n))).astype(
        np.float32)


@pytest.mark.parametrize("n", [16, 128])
def test_blocked_pallas_inverse_and_det_backends(n):
    """``"blocked_pallas"`` is the phase loop on panel kernel 6 with
    nb = min(64, N), bitwise as called directly; with a gradient the
    det's backward inverts through it too."""
    a = _batch(2, n, seed=n + 1)
    at = torch.from_numpy(a)
    x = dispatch.inverse_batched(at, backend="blocked_pallas")
    assert torch.equal(x, lu_blocked.blocked_inverse_batched(
        at, nb=min(64, n), panel_backend="pallas"))
    assert _resid(a, x.numpy()).max() <= 5e-5
    s = torch.from_numpy(_det_batch(2, n, seed=n + 2))
    d = dispatch.det_batched(s, backend="blocked_pallas")
    assert torch.equal(d, lu_blocked.pallas_det_batched(s, nb=min(64, n)))
    grads = []
    for det in (lambda t: dispatch.det_batched(t, "blocked_pallas"),
                torch.linalg.det):
        st = s.clone().requires_grad_()
        det(st).sum().backward()
        grads.append(st.grad)
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(err) <= 1e-4
    with pytest.raises(ValueError, match="no 'blocked_pallas'"):
        dispatch.rank_batched(at, backend="blocked_pallas")


@pytest.mark.parametrize("n", [64, 256])
def test_lu_factor_auto_is_the_blocked_phase_loop(n):
    a = _batch(2, n, seed=n + 3)
    at = torch.from_numpy(a)
    res = dispatch.lu_factor_batched(at)
    want = lu_blocked.blocked_lu_batched(at, nb=64)
    for got, ref in zip(res, want):
        assert torch.equal(got, ref)
    lu = res.lu.double()
    lo = torch.tril(lu, -1) + torch.eye(n, dtype=torch.float64)
    pa = at.double().gather(1, res.perm.long()[:, :, None].expand(-1, -1, n))
    assert float((lo @ torch.triu(lu) - pa).abs().max()) <= 1e-5 * float(
        at.abs().max())
    assert res.ok.all() and set(res.sign.tolist()) <= {1.0, -1.0}


def test_lu_factor_auto_at_1024_splits_the_panels():
    """nb = 64 at N = 1024 is past the panel kernel's shared memory: the
    phase loop factors each panel as two 32-wide sub-panels."""
    n = 1024
    assert lu_blocked.panel_split(n, 64) == 32
    a = torch.from_numpy(_batch(1, n, seed=15))
    res = dispatch.lu_factor_batched(a)
    lu = res.lu.double()
    lo = torch.tril(lu, -1) + torch.eye(n, dtype=torch.float64)
    pa = a.double()[0][res.perm[0].long()]
    assert float((lo[0] @ torch.triu(lu[0]) - pa).abs().max()) <= 1e-5 * \
        float(a.abs().max())


def test_lu_factor_raises_outside_the_blocked_reach():
    """N = 100 is no multiple of min(64, N): ``auto`` takes the LU loop
    (``ops.lu``'s ``LUResult``), as the reference's does, against the
    JAX package's ``"loop"`` at B = 1: perm, sign and ok exactly, the
    packed factors within 1e-5.  ``"xla"`` is no backend of the LU, and
    the facade factors nothing."""
    n = 100
    a = _batch(1, n, seed=n)
    res = dispatch.lu_factor_batched(torch.from_numpy(a))
    want = jdispatch.lu_factor_batched(jnp.asarray(a), backend="loop")
    assert type(res).__name__ == "LUResult"
    for f in ("perm", "sign", "ok"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(want, f)))
    lu_j = np.asarray(want.lu)
    assert np.abs(res.lu.numpy() - lu_j).max() <= 1e-5 * np.abs(lu_j).max()
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.lu_factor_batched(torch.zeros(1, 64, 64), backend="xla")
    with pytest.raises(NotImplementedError, match="no 'pallas' op"):
        dispatch.lu_factor_batched(torch.zeros(1, 64, 64), backend="pallas")


@pytest.mark.parametrize("n", [32, 30], ids=["rbt", "pivoted"])
def test_float64_input_comes_back_float64_on_each_route(n):
    """The kernels compute in f32 on either route; the result takes the
    input's floating dtype."""
    a = torch.from_numpy(_batch(2, n, seed=4).astype(np.float64))
    x = dispatch.inverse_batched(a)
    assert x.dtype == torch.float64
    assert _resid(a.numpy(), x.numpy()).max() <= 5e-5
    s = torch.eye(n, dtype=torch.float64) + a / (40.0 * n)  # |det| ~ 1
    d = dispatch.det_batched(s)
    assert d.dtype == torch.float64
    torch.testing.assert_close(d, torch.linalg.det(s), rtol=1e-4, atol=0)
    assert gj.solve_batched(a, a[:, :, 0]).dtype == torch.float64


def test_xla_backend_is_the_library():
    a = torch.from_numpy(_batch(3, 20, seed=2))
    torch.testing.assert_close(dispatch.inverse_batched(a, "xla"),
                               torch.linalg.inv(a))
    torch.testing.assert_close(dispatch.det_batched(a, "xla"),
                               torch.linalg.det(a))
    assert dispatch.rank_batched(a, "xla").tolist() == [20] * 3
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.inverse_batched(a, backend="rbt")


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_inverse_gradient_matches_library_autograd(backend):
    a = _batch(2, 16, seed=5)
    w = torch.from_numpy(np.random.RandomState(6).randn(2, 16, 16)).float()
    grads = []
    for inv in (lambda t: dispatch.inverse_batched(t, backend),
                torch.linalg.inv):
        at = torch.from_numpy(a).requires_grad_()
        (inv(at) * w).sum().backward()
        grads.append(at.grad)
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(err) <= 1e-4


def test_det_gradient_matches_library_autograd():
    rng = np.random.RandomState(8)
    a = (np.eye(12) + 0.2 * rng.randn(3, 12, 12)).astype(np.float32)
    grads = []
    for det in (dispatch.det_batched, torch.linalg.det):
        at = torch.from_numpy(a).requires_grad_()
        (det(at) * torch.tensor([1.0, -2.0, 0.5])).sum().backward()
        grads.append(at.grad)
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(err) <= 1e-4


def _earlier_facade_route(op, n):
    """``auto``'s inverse and det routes before the loop backend existed,
    or None where they raised."""
    width = {"inverse": 2 * n, "det": n}[op]
    if (op == "inverse" and inv_rbt.fits(n)) or gj.fits(n, width):
        return "pallas"
    if op == "inverse" and dispatch.phase_reaches(n):
        return "rbt"
    if op == "det" and n >= 8 and n % min(64, n) == 0 and n < 1024:
        return "blocked_pallas"
    if n >= 1024:
        return "xla"
    return None


@pytest.mark.parametrize("op", ["inverse", "det"])
def test_auto_keeps_every_earlier_route(op):
    """Every N that ``auto`` routed before keeps its route; what raised
    now takes the loop, as in the reference.  The rank keeps kernel 3 to
    237 and takes it on to 424 (its big reach)."""
    for n in range(1, 1300):
        before = _earlier_facade_route(op, n)
        assert dispatch._resolve_facade("auto", op, n) == (before or "loop")
    assert all(kernels.supports("rank", n) for n in range(1, 425))


@pytest.mark.parametrize("n,backend,route", [
    (238, "auto", "kernel"), (424, "auto", "kernel"),
    (425, "auto", "blocked"), (512, "auto", "blocked"),
    (300, "blocked", "blocked"), (100, "blocked", "loop"),
    (100, "loop", "loop")])
def test_rank_dispatch_routes(monkeypatch, n, backend, route):
    """``rank_batched``: kernel 3 to max(M, N) = 424 (variant 3 past 237),
    the blocked RREF past it from 256, else the loop."""
    rref_blocked = importlib.import_module(
        "linalg_solver_tpu_torch.ops.rref_blocked")
    solve = importlib.import_module("linalg_solver_tpu_torch.ops.solve")

    calls = []
    for mod, name, tag in ((kernels, "rank_batched", "kernel"),
                           (rref_blocked, "rank_blocked_batched", "blocked"),
                           (solve, "rank_batched", "loop")):
        monkeypatch.setattr(mod, name, lambda *a, _t=tag, **k:
                            calls.append(_t))
    dispatch.rank_batched(torch.zeros(1, n, n - 1), backend=backend)
    assert calls == [route]
