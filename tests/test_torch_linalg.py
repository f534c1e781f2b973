"""The port's ``numpy.linalg``-shaped namespace
(``linalg_solver_tpu_torch.linalg``) against the JAX package's
(``linalg_solver_tpu.linalg``) on the same numpy inputs, CPU tensors on
the port's side, with leading batch dims ``()``, ``(3,)`` and ``(2, 2)``,
real and complex.

Values within 1e-4 of the largest entry of the JAX result (the two
packages take different routes at even N < 256, ROADMAP queue 3);
factors determined only up to signs or phases (eigenvectors, singular
vectors, Q) through their defining identities instead; the gradients of
a matrix-RHS solve and of ``slogdet`` within 1e-4 of ``jax.grad``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu import linalg as jla
from linalg_solver_tpu_torch import linalg as tla

N = 6
TOL = 1e-4
LEADS = [(), (3,), (2, 2)]


def _arr(lead, n=N, m=None, cplx=False, seed=0, shift=3.0):
    rng = np.random.RandomState(seed)
    m = m or n
    a = rng.randn(*lead, n, m)
    if cplx:
        a = a + 1j * rng.randn(*lead, n, m)
    if n == m:
        a = a + shift * np.sqrt(n) * np.eye(n)
    return a.astype(np.complex64 if cplx else np.float32)


def _np(x):
    x = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale


def _both(name, *args, **kw):
    """(port, JAX) results of ``name`` on the same numpy arguments."""
    got = getattr(tla, name)(*[torch.from_numpy(np.array(a)) for a in args],
                             **kw)
    want = getattr(jla, name)(*[jnp.asarray(a) for a in args], **kw)
    return got, want


@pytest.mark.parametrize("cplx", [False, True])
def test_solve_inv_det_slogdet_match_jax(cplx):
    for lead in LEADS:
        a = _arr(lead, cplx=cplx)
        rng = np.random.RandomState(1)
        b = rng.randn(*lead, N).astype(np.float32)
        bm = rng.randn(*lead, N, 3).astype(np.float32)
        for rhs in (b, bm):
            _close(*_both("solve", a, rhs))
        for name in ("inv", "det"):
            _close(*_both(name, a))
        (s_t, l_t), (s_j, l_j) = _both("slogdet", a)
        _close(s_t, s_j)
        _close(l_t, l_j)
        assert l_t.shape == lead


@pytest.mark.parametrize("cplx", [False, True])
def test_spectral_entry_points_match_jax(cplx):
    """eig, eigvals (spectra as sorted multisets), eigh, eigvalsh (ascending
    eigenvalues; eigenvectors by ‖A V − V Λ‖) on a (2,)-batch."""
    a = _arr((2,), cplx=cplx, shift=0.0)
    h = (a + np.conj(np.swapaxes(a, -1, -2))) / 2
    (w_t, v_t), (w_j, _) = _both("eig", a)
    for b in range(2):
        _close(np.sort_complex(_np(w_t)[b]), np.sort_complex(_np(w_j)[b]))
        v, w = _np(v_t)[b], _np(w_t)[b]
        r = a[b].astype(np.complex128) @ v - v * w
        assert np.abs(r).max() <= TOL * np.abs(a[b]).max()
    ev_t, ev_j = _both("eigvals", a)
    for b in range(2):
        _close(np.sort_complex(_np(ev_t)[b]), np.sort_complex(_np(ev_j)[b]))
    (w_t, v_t), (w_j, _) = _both("eigh", h)
    _close(w_t, w_j)
    r = h.astype(np.complex128) @ _np(v_t) - _np(v_t) * _np(w_t)[:, None, :]
    assert np.abs(r).max() <= TOL * np.abs(h).max()
    _close(*_both("eigvalsh", h))


@pytest.mark.parametrize("cplx", [False, True])
def test_factorizations_match_jax(cplx):
    """svd (σ, and U Σ Vᴴ = A; full_matrices pads unitary factors),
    svdvals, qr (R's diagonal magnitudes, Q R = A), cholesky, lstsq with
    a vector and a matrix RHS, pinv, matrix_rank, cond in every norm."""
    t = _arr((2,), n=8, m=5, cplx=cplx, seed=2)
    (u, s, vh), (_, s_j, _) = _both("svd", t)
    _close(s, s_j)
    rec = (_np(u) * _np(s)[:, None, :]) @ _np(vh)
    assert np.abs(rec - t).max() <= TOL * np.abs(t).max()
    u_f, _, vh_f = tla.svd(torch.from_numpy(t), full_matrices=True)
    assert u_f.shape == (2, 8, 8) and vh_f.shape == (2, 5, 5)
    uf = _np(u_f)
    gram = np.conj(np.swapaxes(uf, 1, 2)) @ uf
    assert np.abs(gram - np.eye(8)).max() <= 1e-5
    _close(*_both("svdvals", t))
    (q, r), (_, r_j) = _both("qr", t)
    _close(np.abs(np.diagonal(_np(r), axis1=1, axis2=2)),
           np.abs(np.diagonal(_np(r_j), axis1=1, axis2=2)))
    assert np.abs(_np(q) @ _np(r) - t).max() <= TOL * np.abs(t).max()
    g = np.conj(np.swapaxes(t, 1, 2)) @ t + np.eye(5, dtype=t.dtype)
    _close(*_both("cholesky", g))
    rng = np.random.RandomState(3)
    b = rng.randn(2, 8).astype(np.float32)
    bm = rng.randn(2, 8, 2).astype(np.float32)
    _close(*_both("lstsq", t, b))
    _close(*_both("lstsq", t, bm))
    _close(*_both("pinv", t))
    rank_t, rank_j = _both("matrix_rank", t)
    np.testing.assert_array_equal(_np(rank_t), _np(rank_j))
    a = _arr((2,), cplx=cplx, seed=4)
    for p in (None, 2, -2, 1, -1, np.inf, -np.inf, "fro"):
        _close(*_both("cond", a, p=p))


def test_helpers_match_jax():
    """matrix_power (±3, 0), matrix_norm in every order, vector_norm,
    vecdot, outer, cross, diagonal, trace, matmul, tensordot, multi_dot,
    tensorsolve, tensorinv, matrix_transpose and norm."""
    a = _arr((2,), seed=5, shift=1.0)
    for k in (3, -3, 0):
        _close(*_both("matrix_power", a, k))
    for o in ("fro", "nuc", 2, -2, 1, -1, np.inf, -np.inf):
        _close(*_both("matrix_norm", a, ord=o))
    rng = np.random.RandomState(6)
    x = rng.randn(4, 3).astype(np.float32)
    y = rng.randn(4, 3).astype(np.float32)
    _close(*_both("vector_norm", x, axis=1))
    _close(*_both("vecdot", x, y))
    _close(*_both("outer", x[0], y[0]))
    _close(*_both("cross", x, y))
    _close(*_both("diagonal", a, offset=1))
    _close(*_both("trace", a))
    _close(*_both("matmul", a, a))
    for axes in (1, 2):
        _close(*_both("tensordot", a[0], a[1], axes=axes))
    _close(*_both("matrix_transpose", a))
    _close(tla.norm(torch.from_numpy(a)), jla.norm(jnp.asarray(a)))
    chain = [rng.randn(3).astype(np.float32),
             rng.randn(3, 7).astype(np.float32),
             rng.randn(7, 2).astype(np.float32),
             rng.randn(2).astype(np.float32)]
    _close(tla.multi_dot([torch.from_numpy(c) for c in chain]),
           jla.multi_dot([jnp.asarray(c) for c in chain]))
    t = (rng.randn(2, 3, 6) + 3 * np.eye(6).reshape(2, 3, 6)).astype(
        np.float32)
    t4 = t.reshape(2, 3, 2, 3)
    _close(*_both("tensorinv", t4, ind=2))
    bt = rng.randn(2, 3).astype(np.float32)
    _close(*_both("tensorsolve", t4, bt))


def test_solve_gradient_matches_jax():
    """The matrix-RHS solve's backward (one transposed solve) against
    ``jax.grad`` of the same loss, real and through the complex
    embedding's real parts."""
    a = _arr((2,), seed=7)
    b = np.random.RandomState(8).randn(2, N, 3).astype(np.float32)
    w = np.random.RandomState(9).randn(2, N, 3).astype(np.float32)
    ga, gb = jax.grad(lambda a_, b_: jnp.sum(jla.solve(a_, b_) * w),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    (tla.solve(at, bt) * torch.from_numpy(w)).sum().backward()
    _close(at.grad, ga)
    _close(bt.grad, gb)


def test_slogdet_gradient_matches_jax():
    a = _arr((3,), seed=10)
    g = jax.grad(lambda a_: jnp.sum(jla.slogdet(a_)[1]))(jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_()
    sign, logabs = tla.slogdet(at)
    logabs.sum().backward()
    _close(at.grad, g)
    assert not sign.requires_grad


def test_non_tensor_input_goes_to_the_card():
    """A numpy argument goes to the CUDA device: without one it raises
    (no CPU fallback); a tensor keeps its device."""
    a = _arr(())
    x = tla.det(torch.from_numpy(a))
    assert x.device.type == "cpu"
    if torch.cuda.is_available():
        assert tla.det(a).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tla.det(a)
