"""The masked triangular Sylvester solve (``linalg_solver_tpu_torch.ops.
kernels.trsyl``, the plain version the CPU takes) against the JAX
package's ``_trsyl_masked``, on the same reordered complex Schur form
(computed once by the JAX package) and the same right-hand sides.

X within 1e-5 of its largest entry, ``pert`` exact, in both directions;
a lane that splits a repeated eigenvalue between the clusters sets
``pert``; lanes with an empty or full cluster give zeros.  In float64
(no JAX counterpart here) the residual of each equation is at roundoff.
The kernel itself runs only on the card: ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import ordschur as jord
from linalg_solver_tpu.ops.schur import real_schur_vectors as jschur
from linalg_solver_tpu_torch.ops.kernels import trsyl

N = 10


def _t(x):
    return torch.from_numpy(np.array(x))


def _forms():
    """Four lanes of a reordered complex Schur form [4, N, N] and their m:
    Re λ < 0 selected on three Gaussian lanes; a triangular lane whose
    repeated eigenvalue 2 is split across the clusters."""
    rng = np.random.RandomState(3)
    A = rng.randn(3, N, N).astype(np.float32)
    sv = jschur(jnp.asarray(A))
    cs = jord.rsf2csf_batched(sv.T, sv.Q)
    sel = np.diagonal(np.asarray(cs.t_re), axis1=1, axis2=2) < 0
    T2 = np.triu(rng.randn(N, N)).astype(np.float32)
    np.fill_diagonal(T2, [2.0, 2.0] + list(range(3, N + 1)))
    s2 = np.zeros(N, bool)
    s2[0] = True
    os = jord.schur_reorder_batched(
        jnp.asarray(np.concatenate([np.asarray(sv.T), T2[None]])),
        jnp.asarray(np.concatenate([np.asarray(sv.Q),
                                    np.eye(N, dtype=np.float32)[None]])),
        jnp.asarray(np.concatenate([sel, s2[None]])))
    return np.array(os.t_re), np.array(os.t_im), np.array(os.m)


@pytest.fixture(scope="module")
def forms():
    return _forms()


def _rhs(m, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(len(m), N, N).astype(np.float32),
            rng.randn(len(m), N, N).astype(np.float32))


@pytest.mark.parametrize("adjoint", [False, True])
def test_plain_version_matches_jax(forms, adjoint):
    t_re, t_im, m = forms
    c_re, c_im = _rhs(m, 5 + adjoint)
    xj_re, xj_im, pj = jord._trsyl_masked(
        jnp.asarray(t_re), jnp.asarray(t_im), jnp.asarray(m),
        jnp.asarray(c_re), jnp.asarray(c_im), adjoint=adjoint)
    xr, xi, pt = trsyl.trsyl_masked(_t(t_re), _t(t_im), _t(m), _t(c_re),
                                    _t(c_im), adjoint=adjoint)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert pt.tolist() == [False, False, False, True]
    for got, want in ((xr, xj_re), (xi, xj_im)):
        want = np.asarray(want, np.float64)
        # the perturbed lane's X is of the order 1/smin: roundoff decides
        # its digits in both packages
        err = np.abs(got.double().numpy() - want)[:3].max()
        assert err <= 1e-5 * np.abs(want[:3]).max()


@pytest.mark.parametrize("adjoint", [False, True])
def test_float64_residual(adjoint):
    """T11 X − X T22 = C (or the adjoint equation) on the block, zero
    outside it, in float64."""
    rng = np.random.RandomState(8)
    n, m = 9, np.array([4, 0, 9, 6])
    T = np.triu(rng.randn(4, n, n) + 1j * rng.randn(4, n, n))
    for b in range(4):
        np.fill_diagonal(T[b], np.arange(n) + 1j * rng.randn(n))
    C = rng.randn(4, n, n) + 1j * rng.randn(4, n, n)
    xr, xi, pert = trsyl.trsyl_masked(
        _t(T.real), _t(T.imag), _t(m.astype(np.int32)), _t(C.real),
        _t(C.imag), adjoint=adjoint)
    assert xr.dtype == torch.float64 and not bool(pert.any())
    X = xr.numpy() + 1j * xi.numpy()
    for b, k in enumerate(m):
        Y = X[b][:k, k:]
        T11, T22 = T[b][:k, :k], T[b][k:, k:]
        if adjoint:
            T11, T22 = T11.conj().T, T22.conj().T
        R = T11 @ Y - Y @ T22 - C[b][:k, k:]
        assert np.abs(R).max(initial=0.0) <= 1e-12 * max(
            np.abs(Y).max(initial=0.0), 1.0)
        outside = X[b].copy()
        outside[:k, k:] = 0
        assert np.abs(outside).max() == 0.0


def test_wrapper_checks_and_reach(forms):
    t_re, t_im, m = forms
    args = [_t(t_re), _t(t_im), _t(m), _t(t_re), _t(t_im)]
    with pytest.raises(ValueError):
        trsyl.trsyl_masked(args[0], args[1], args[2][:2], *args[3:])
    with pytest.raises(ValueError):
        trsyl.trsyl_masked(*args[:3], args[3].double(), args[4])
    with pytest.raises(TypeError):
        trsyl.trsyl_masked(*(a.half() if a.is_floating_point() else a
                             for a in args))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        trsyl.trsyl_masked(*meta)
    assert trsyl.fits(256, torch.float32) and trsyl.fits(1024, torch.float64)
    assert not trsyl.fits(1025, torch.float32)
    assert not trsyl.fits(64, torch.float16)
    # the CPU takes the plain version: no launch is counted
    before = trsyl.LAUNCHES
    trsyl.trsyl_masked(*args)
    assert trsyl.LAUNCHES == before
