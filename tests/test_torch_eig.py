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
reference's own test (tiny ``s``, large error estimate).

Some of its cases live in ``tests/test_torch_eig_jax.py`` (files of at
most 11 tests: pytest-xdist's ``--dist loadfile`` queues a file by its
number of tests, and so queues these after the slow JAX file
``tests/test_lu_large.py``)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from linalg_solver_tpu.ops import schur as jschur
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
