"""The port's full eigendecomposition (``linalg_solver_tpu_torch.ops.schur
.eig_batched``), its inverse-iteration back-substitution
(``_shifted_backsolve``), the eigenvalue condition numbers
(``eig_condition_batched``) and the polynomial roots
(``ops.roots.roots_batched``) against the JAX package, fed the same
numpy inputs.

The two Schur solvers round differently, so their Schur forms list the
eigenvalues in different orders: each lane's eigenvalues are matched one
to one (``linear_sum_assignment``) and the flags, values and vectors are
compared through that matching.  Exact: ``valid``, ``converged``,
``clean`` and ``ok``.  Values: eigenvalues within 1e-5 of the lane's
largest modulus, eigenvectors up to a unit phase a column
(``|v_portᴴ v_jax| ≥ 1 − 1e-4``), condition numbers within 1e-4
relative, ``_shifted_backsolve`` on the JAX package's own T within 1e-5.
The batch: two Gaussian lanes, a skew-symmetric one (every eigenvalue a
complex pair) and the reference's near-defective Jordan chain, whose
eigenvalues no two roundings place alike: there both are held to the
reference's own test (tiny ``s``, large error estimate)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from linalg_solver_tpu.ops import schur as jschur
from linalg_solver_tpu.ops.roots import roots_batched as jroots
from linalg_solver_tpu_torch.ops import schur as tschur
from linalg_solver_tpu_torch.ops.roots import roots_batched as troots

N = 16
TOL_EIG = 1e-5
TOL_VEC = 1e-4
TOL_S = 1e-4
JORDAN = 3           # the near-defective lane


def _batch():
    """[4, 16, 16]: lanes 0-1 Gaussian / sqrt(n), lane 2 skew, lane 3 the
    input of ``test_ops_schur.py``'s ``test_near_defective_flags_tiny_s``
    (a 16-block at 0.5 under a seeded similarity)."""
    rng = np.random.RandomState(5)
    a = np.empty((4, N, N), np.float32)
    a[:2] = rng.randn(2, N, N) / np.sqrt(N)
    s = rng.randn(N, N)
    a[2] = s - s.T
    rng = np.random.RandomState(6)
    J = (np.eye(N) * 0.5 + np.eye(N, k=1)).astype(np.float32)
    P = rng.randn(N, N).astype(np.float32)
    a[JORDAN] = np.linalg.solve(P, J @ P).astype(np.float32)
    return a


def _lam(res):
    return (np.asarray(res.real, np.float64)
            + 1j * np.asarray(res.imag, np.float64))


def _vecs(res):
    return (np.asarray(res.vectors_real, np.float64)
            + 1j * np.asarray(res.vectors_imag, np.float64))


def _match(lj, lt):
    """Column permutations (of the JAX lane, of the port's lane) pairing
    each eigenvalue with its nearest counterpart."""
    return linear_sum_assignment(np.abs(lj[:, None] - lt[None, :]))


def _hold_eig(rj, rt, lanes):
    """Flags exactly, eigenvalues and eigenvectors within the tolerances,
    through the one-to-one eigenvalue matching on ``lanes``."""
    lj, lt = _lam(rj), _lam(rt)
    Vj, Vt = _vecs(rj), _vecs(rt)
    vj, vt = np.asarray(rj.valid), rt.valid.numpy()
    np.testing.assert_array_equal(np.asarray(rj.converged),
                                  rt.converged.numpy())
    if rj.clean is not None:
        np.testing.assert_array_equal(np.asarray(rj.clean), rt.clean.numpy())
    for b in lanes:
        r, c = _match(lj[b], lt[b])
        scale = np.abs(lj[b]).max()
        assert np.abs(lj[b][r] - lt[b][c]).max() <= TOL_EIG * scale
        np.testing.assert_array_equal(vj[b][r], vt[b][c])
        keep = vj[b][r]
        overlap = np.abs((Vj[b][:, r].conj() * Vt[b][:, c]).sum(0))
        assert overlap[keep].min() >= 1 - TOL_VEC
        # invalid columns are zero in both
        assert not Vt[b][:, c][:, ~keep].any()


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def jax_eig(batch):
    return {k: jschur.eig_batched(jnp.asarray(batch), refine_steps=k)
            for k in (0, 1)}


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


def test_eig_batched_refine_is_monotone(batch):
    """The accept-if-better gate: no column's residual in the original
    basis grows by refinement (up to float32 rounding of the check)."""
    a64 = batch[:3].astype(np.float64)
    got = {}
    for k in (0, 1):
        rt = tschur.eig_batched(torch.from_numpy(batch[:3]), refine_steps=k)
        lam, V = _lam(rt), _vecs(rt)
        got[k] = np.linalg.norm(a64 @ V - V * lam[:, None, :], axis=1)
    assert (got[1] <= got[0] + 1e-6).all()


@pytest.mark.parametrize("a", [
    np.array([[[0.0, -2.0], [2.0, 0.0]]], np.float32),
    np.array([[[1.0, 3.0], [0.5, -2.0]]], np.float32),
    np.array([[[-0.75]], [[2.5]]], np.float32),
], ids=["2x2-pair", "2x2-real", "1x1"])
def test_eig_batched_small_cases(a):
    """The 1×1 and 2×2 cases (``real_schur_vectors``' direct path): a
    conjugate pair's second column is the conjugate of the first."""
    rj = jschur.eig_batched(jnp.asarray(a))
    rt = tschur.eig_batched(torch.from_numpy(a))
    _hold_eig(rj, rt, lanes=range(a.shape[0]))
    if a.shape[1] == 2 and a[0, 0, 1] == -2.0:
        Vr, Vi = rt.vectors_real[0], rt.vectors_imag[0]
        assert torch.allclose(Vr[:, 1], Vr[:, 0], atol=1e-6)
        assert torch.allclose(Vi[:, 1], -Vi[:, 0], atol=1e-6)
        assert sorted(rt.imag[0].tolist()) == pytest.approx([-2.0, 2.0],
                                                            abs=1e-5)


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


def test_eig_condition_against_float64(batch):
    """The port's s against numpy's float64 left/right eigenvectors, the
    reference's oracle (``test_ops_schur.py``'s ``test_matches_f64_oracle``)."""
    rt = tschur.eig_condition_batched(torch.from_numpy(batch[:2]))
    lam = _lam(rt)
    for b in range(2):
        a64 = batch[b].astype(np.float64)
        w, V = np.linalg.eig(a64)
        w2, W2 = np.linalg.eig(a64.T)
        for i, lv in enumerate(lam[b]):
            v = V[:, int(np.argmin(np.abs(w - lv)))]
            y = np.conj(W2[:, int(np.argmin(np.abs(w2 - lv)))])
            want = abs(np.vdot(y, v)) / (np.linalg.norm(v)
                                         * np.linalg.norm(y))
            assert abs(float(rt.s[b, i]) - want) < 1e-4


def _poly_batch():
    """[4, 6] coefficients, highest first: Gaussian, (x-1)…(x-5), x⁵ + 1
    (complex roots) and a zero leading coefficient."""
    rng = np.random.RandomState(3)
    c = rng.randn(4, 6).astype(np.float32)
    c[0, 0] += np.sign(c[0, 0])
    c[1] = np.poly([1.0, 2.0, 3.0, 4.0, 5.0])
    c[2] = [1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    c[3, 0] = 0.0
    return c


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


def test_roots_degree_checks():
    with pytest.raises(ValueError):
        troots(torch.ones(2, 1))
    res = troots(torch.tensor([[2.0, -3.0]]))
    assert res.real.tolist() == [[1.5]] and res.imag.tolist() == [[0.0]]


def test_ops_exports():
    """The names the reference's ``ops`` has, in the same places."""
    tops = importlib.import_module("linalg_solver_tpu_torch.ops")
    jops = importlib.import_module("linalg_solver_tpu.ops")
    names = ("EigFullResult", "eig_batched", "RootsResult", "roots_batched",
             "SignResult", "sign_batched", "eig_count_left_batched",
             "spectral_projector_batched", "SylvesterResult",
             "sylvester_batched", "lyapunov_batched", "SteinResult",
             "stein_batched", "CAREResult", "care_batched", "DAREResult",
             "dare_batched", "GeneralizedEighResult",
             "eigh_generalized_batched", "GeneralizedEigResult",
             "eig_generalized_batched", "GeneralizedEigShifted",
             "eig_generalized_shifted_batched", "PolyEigResult",
             "polyeig_batched", "QuadEigResult", "quadeig_batched")
    for name in names:
        assert name in tops.__all__ and name in jops.__all__
        assert callable(getattr(tops, name))
        ref = getattr(jops, name)
        if hasattr(ref, "_fields"):
            assert getattr(tops, name)._fields == ref._fields
    assert hasattr(tops.schur, "eig_condition_batched")
    assert "eig_condition_batched" not in tops.__all__
