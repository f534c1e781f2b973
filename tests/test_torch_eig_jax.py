"""``eig_batched``, the roots and the shifted backsolve against the JAX
package on the same inputs.  Split from ``tests/test_torch_eig.py`` (its
helpers and tolerances)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import schur as jschur
from linalg_solver_tpu.ops.roots import roots_batched as jroots
from linalg_solver_tpu_torch.ops import schur as tschur
from linalg_solver_tpu_torch.ops.roots import roots_batched as troots

from test_torch_eig import (JORDAN, N, TOL_EIG, TOL_S, _hold_eig, _lam,
                            _match, _poly_batch, _vecs, batch, jax_eig)


@pytest.mark.parametrize("refine_steps", [0, 1])
def test_eig_batched_matches_jax(batch, jax_eig, refine_steps):
    rt = tschur.eig_batched(torch.from_numpy(batch),
                            refine_steps=refine_steps)
    assert type(rt).__name__ == "EigFullResult"
    assert rt._fields == jax_eig[refine_steps]._fields
    _hold_eig(jax_eig[refine_steps], rt, lanes=(0, 1, 2))
    # the skew lane: every eigenvalue imaginary, every column valid
    assert np.abs(rt.real[2].numpy()).max() <= 1e-5 * np.abs(batch[2]).max()
    assert bool(rt.valid[2].all())
    # refinement never makes a column worse than the raw strevc output
    lam, V = _lam(rt), _vecs(rt)
    for b in (0, 1, 2):
        res = np.linalg.norm(batch[b].astype(np.float64) @ V[b]
                             - V[b] * lam[b][None, :], axis=0)
        assert res.max() / np.abs(batch[b]).max() < 1e-4


def test_shifted_backsolve_on_jax_T(batch):
    """On the JAX package's own Schur form, complex shifts and right
    sides: both solutions within 1e-5 of each other (relative to the
    largest entry), and both solve the shifted system."""
    rng = np.random.RandomState(0)
    sv = jschur.real_schur_vectors(jnp.asarray(batch[:3]))
    T = np.asarray(sv.T)
    lr = rng.randn(3, N).astype(np.float32)
    li = rng.randn(3, N).astype(np.float32)
    lr[:, :4], li[:, :4] = 0.123, 0.456
    R_re = rng.randn(3, N, N).astype(np.float32)
    R_im = rng.randn(3, N, N).astype(np.float32)
    args = (T.copy(), lr, li, R_re, R_im)
    wj = jschur._shifted_backsolve(*map(jnp.asarray, args))
    wt = tschur._shifted_backsolve(*map(torch.from_numpy, args))
    Wj = np.asarray(wj[0], np.float64) + 1j * np.asarray(wj[1], np.float64)
    Wt = wt[0].double().numpy() + 1j * wt[1].double().numpy()
    assert np.abs(Wt - Wj).max() <= 1e-5 * np.abs(Wj).max()
    R = R_re + 1j * R_im
    lam = lr + 1j * li
    for b in range(3):
        for i in range(4):
            M = T[b].astype(np.float64) - lam[b, i] * np.eye(N)
            assert np.abs(M @ Wt[b][:, i] - R[b][:, i]).max() < 1e-4


def test_shifted_backsolve_rectangular_right_side():
    """k ≠ n columns (the Sylvester solve's shape), a shift on an
    eigenvalue (the safeguarded pivot) included."""
    rng = np.random.RandomState(1)
    a = rng.randn(2, N, N).astype(np.float32)
    sv = jschur.real_schur_vectors(jnp.asarray(a))
    T = np.array(sv.T)
    lr = rng.randn(2, 5).astype(np.float32)
    li = np.zeros((2, 5), np.float32)
    lr[:, 0] = T[:, N - 1, N - 1]
    R_re = rng.randn(2, N, 5).astype(np.float32)
    R_im = rng.randn(2, N, 5).astype(np.float32)
    args = (T, lr, li, R_re, R_im)
    wj = jschur._shifted_backsolve(*map(jnp.asarray, args))
    wt = tschur._shifted_backsolve(*map(torch.from_numpy, args))
    for x, y in zip(wj, wt):
        x = np.asarray(x)
        assert y.shape == x.shape
        fin = np.isfinite(x)
        np.testing.assert_array_equal(fin, np.isfinite(y.numpy()))
        assert np.abs(y.numpy()[fin] - x[fin]).max() <= 1e-5 * np.abs(
            x[fin]).max()


def test_eig_condition_matches_jax(batch):
    rj = jschur.eig_condition_batched(jnp.asarray(batch))
    rt = tschur.eig_condition_batched(torch.from_numpy(batch))
    assert rt._fields == rj._fields
    np.testing.assert_array_equal(np.asarray(rj.converged),
                                  rt.converged.numpy())
    lj, lt = _lam(rj), _lam(rt)
    for b in (0, 1, 2):
        r, c = _match(lj[b], lt[b])
        assert np.abs(lj[b][r] - lt[b][c]).max() <= TOL_EIG * np.abs(
            lj[b]).max()
        np.testing.assert_array_equal(np.asarray(rj.valid)[b][r],
                                      rt.valid.numpy()[b][c])
        sj, st = np.asarray(rj.s)[b][r], rt.s.numpy()[b][c]
        assert np.abs(st - sj).max() <= TOL_S * sj.max()
        assert (np.abs(st - sj) <= TOL_S * sj).all()
        # err_est = eps·max|T|/s: max|T| depends on the Schur order (T's
        # off-diagonal part is not invariant), so the lane's scale differs
        # between the two forms; per column it is that scale over s
        ej, et = np.asarray(rj.err_est)[b][r], rt.err_est.numpy()[b][c]
        kt, kj = et * st, ej * sj
        assert np.ptp(kt) <= 1e-5 * kt.max() and np.ptp(kj) <= 1e-5 * kj.max()
        assert 0.5 <= kt[0] / kj[0] <= 2.0
    s = rt.s.numpy()
    assert (s > 0).all() and (s <= 1 + 1e-6).all()
    # the Jordan chain: the reference's own verdict, in both packages
    for res in (rj, rt):
        assert float(np.asarray(res.s)[JORDAN].min()) < 1e-3
        assert float(np.asarray(res.err_est)[JORDAN].max()) > 1e-2


def test_roots_matches_jax():
    c = _poly_batch()
    rj = jroots(jnp.asarray(c))
    rt = troots(torch.from_numpy(c))
    assert rt._fields == rj._fields
    np.testing.assert_array_equal(np.asarray(rj.ok), rt.ok.numpy())
    np.testing.assert_array_equal(np.asarray(rj.converged),
                                  rt.converged.numpy())
    assert rt.ok.tolist() == [True, True, True, False]
    lj, lt = _lam(rj), _lam(rt)
    for b in range(3):
        # (x-1)…(x-5)'s roots are ill-conditioned: in float32 the two
        # packages' roundings land 1e-4 apart there, each within 1e-3 of
        # numpy's float64 roots (the reference's own test of them)
        if b != 1:
            r, cc = _match(lj[b], lt[b])
            assert np.abs(lj[b][r] - lt[b][cc]).max() <= TOL_EIG * np.abs(
                lj[b]).max()
        want = np.roots(c[b].astype(np.float64))
        r, cc = _match(want, lt[b])
        assert np.abs(want[r] - lt[b][cc]).max() <= 1e-3 * max(
            np.abs(want).max(), 1.0)
