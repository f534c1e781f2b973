"""The port's matrix equations against the JAX package, fed the same numpy
inputs: the matrix sign function and what is built on it
(``linalg_solver_tpu_torch.ops.sign``), Sylvester, Lyapunov and Stein
(``ops.sylvester``), and the continuous and discrete Riccati equations
(``ops.riccati``).

Exact: ``converged``, ``ok``, ``iters`` and the eigenvalue counts.
Values: the solution (S, X) within 1e-4 of the largest entry of the JAX
package's.  Every batch is [3, 12, 12] (the Hamiltonian [3, 24, 24]), so
each JAX function compiles once.  The reference's edge cases ride along
as lanes: a B with complex eigenvalues only, a divergent Stein lane
(ρ(A) > 1) and a CARE whose Hamiltonian has eigenvalues on the imaginary
axis."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import riccati as jric
from linalg_solver_tpu.ops import sign as jsign
from linalg_solver_tpu.ops import sylvester as jsyl
from linalg_solver_tpu_torch.ops import riccati as tric
from linalg_solver_tpu_torch.ops import sign as tsign
from linalg_solver_tpu_torch.ops import sylvester as tsyl

B, N, M = 3, 12, 4
TOL = 1e-4


def _run(jfn, tfn, *args, **kw):
    rj = jfn(*map(jnp.asarray, args), **kw)
    rt = tfn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in args),
             **kw)
    return rj, rt


def _close(got, want, lanes=None, tol=TOL):
    want = np.asarray(want, np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    for b in range(want.shape[0]) if lanes is None else lanes:
        assert np.abs(got[b] - want[b]).max() <= tol * np.abs(want[b]).max()


def _exact(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def spectrum_matrix(eigs, seed):
    """Real matrix with the given real spectrum (a random similarity), as
    the reference's sign tests build them."""
    rng = np.random.RandomState(seed)
    P = np.eye(len(eigs)) + 0.3 * rng.randn(len(eigs), len(eigs))
    return np.linalg.solve(P, np.diag(eigs) @ P).astype(np.float32)


def _sign_batch():
    """Lane 0 right-shifted (sign = I), lane 1 a mixed real spectrum off
    the counting lines σ = -1, 0, 2, lane 2 Gaussian × 2 (complex pairs
    on both sides)."""
    rng = np.random.RandomState(1)
    a = np.empty((B, N, N), np.float32)
    a[0] = rng.randn(N, N) + 3 * np.sqrt(N) * np.eye(N)
    a[1] = spectrum_matrix([-4.0, -3.0, -2.5, -1.5, -0.5, 0.5, 1.0, 2.5,
                            3.0, 4.0, 5.0, 6.0], seed=4)
    a[2] = 2.0 * rng.randn(N, N)
    return a


@pytest.fixture(scope="module")
def sign_batch():
    return _sign_batch()


def test_sign_matches_jax(sign_batch):
    rj, rt = _run(jsign.sign_batched, tsign.sign_batched, sign_batch)
    assert rt._fields == rj._fields
    _exact(rt.converged, rj.converged)
    assert int(rt.iters) == int(rj.iters)
    assert bool(rt.converged.all())
    _close(rt.S, rj.S)
    S = rt.S.double().numpy()
    for b in range(B):
        assert np.abs(S[b] @ S[b] - np.eye(N)).max() <= 1e-3
    assert np.abs(S[0] - np.eye(N)).max() <= 1e-3


def test_sign_frozen_lanes_stay_frozen(sign_batch):
    """A lane done at the start is never stepped: the identity (S = I at
    once) next to lanes that need several steps comes back bitwise."""
    a = sign_batch.copy()
    a[0] = np.eye(N, dtype=np.float32)
    rj, rt = _run(jsign.sign_batched, tsign.sign_batched, a)
    assert int(rt.iters) == int(rj.iters) > 1
    assert torch.equal(rt.S[0], torch.eye(N))
    _exact(rt.converged, rj.converged)


@pytest.mark.parametrize("sigma", [-1.0, 0.0, 2.0])
def test_eig_count_and_projector_match_jax(sign_batch, sigma):
    (cj, okj), (ct, okt) = _run(jsign.eig_count_left_batched,
                                tsign.eig_count_left_batched, sign_batch,
                                sigma=sigma)
    _exact(okt, okj)
    _exact(ct, cj)
    for b in range(B):
        if bool(okt[b]):
            want = int((np.linalg.eigvals(sign_batch[b].astype(np.float64))
                        .real < sigma).sum())
            assert int(ct[b]) == want
    (Pj, okj), (Pt, okt) = _run(jsign.spectral_projector_batched,
                                tsign.spectral_projector_batched,
                                sign_batch, sigma=sigma)
    _exact(okt, okj)
    P = Pt.double().numpy()
    for b in range(B):
        assert np.abs(P[b] @ P[b] - P[b]).max() <= 1e-3
        assert np.abs(P[b] - np.asarray(Pj[b], np.float64)).max() <= TOL


def _sylvester_batch():
    """A = G + 2√n I; B likewise on lanes 0-1, and on lane 2 six rotation
    blocks (every eigenvalue complex); C Gaussian."""
    rng = np.random.RandomState(2)
    shift = 2.0 * np.sqrt(N) * np.eye(N)
    a = (rng.randn(B, N, N) + shift).astype(np.float32)
    b = (rng.randn(B, N, N) + shift).astype(np.float32)
    b[2] = 0.0
    rot = np.array([[1.0, -3.0], [3.0, 1.0]], np.float32)
    for k in range(N // 2):
        b[2, 2 * k:2 * k + 2, 2 * k:2 * k + 2] = rot * (k + 1)
    c = rng.randn(B, N, N).astype(np.float32)
    return a, b, c


def test_sylvester_matches_jax():
    from scipy.linalg import solve_sylvester

    a, b, c = _sylvester_batch()
    rj, rt = _run(jsyl.sylvester_batched, tsyl.sylvester_batched, a, b, c)
    assert rt._fields == rj._fields
    _exact(rt.ok, rj.ok)
    assert bool(rt.ok.all())
    _close(rt.X, rj.X)
    assert float(rt.imag_defect.max()) <= 1e-4
    assert float(np.asarray(rj.imag_defect).max()) <= 1e-4
    for i in range(B):
        want = solve_sylvester(*(x[i].astype(np.float64) for x in (a, b, c)))
        assert np.abs(rt.X[i].double().numpy() - want).max() <= TOL * max(
            1.0, np.abs(want).max())


def test_lyapunov_matches_jax():
    a, _, q = _sylvester_batch()
    q = q + q.transpose(0, 2, 1)
    a[1] = -a[1]                          # a stable lane: the Gramian case
    rj, rt = _run(jsyl.lyapunov_batched, tsyl.lyapunov_batched, a, q)
    _exact(rt.ok, rj.ok)
    assert bool(rt.ok.all())
    _close(rt.X, rj.X)
    X = rt.X.double().numpy()
    for i in range(B):
        R = a[i] @ X[i] + X[i] @ a[i].T - q[i]
        assert np.abs(R).max() <= 1e-3 * np.abs(q[i]).max()


def test_stein_matches_jax():
    """Two stable lanes and a divergent one (``test_ops_sylvester.py``'s
    ``test_unstable_lane_flagged``): ``ok`` False there only, and ``iters``
    the reference's."""
    from scipy.linalg import solve_discrete_lyapunov

    rng = np.random.RandomState(40)
    a = (rng.randn(B, N, N) * (0.5 / np.sqrt(N))).astype(np.float32)
    a[2] *= 6.0                           # ρ(A) ≈ 3
    g = rng.randn(B, N, N)
    q = (np.einsum("bij,bkj->bik", g, g) / N).astype(np.float32)
    rj, rt = _run(jsyl.stein_batched, tsyl.stein_batched, a, q)
    assert rt._fields == rj._fields
    _exact(rt.ok, rj.ok)
    assert rt.ok.tolist() == [True, True, False]
    assert int(rt.iters) == int(rj.iters)
    _close(rt.X, rj.X, lanes=(0, 1))
    for i in (0, 1):
        want = solve_discrete_lyapunov(a[i].astype(np.float64),
                                       q[i].astype(np.float64))
        assert np.abs(rt.X[i].double().numpy() - want).max() <= 1e-5 * (
            np.abs(want).max())


def _riccati_batch(discrete):
    """The reference's scipy-matching inputs on lanes 0-1; lane 2, for the
    CARE, an undamped oscillator B does not reach and Q does not see
    (``test_ops_sylvester.py``'s ``test_imaginary_axis_flagged``: its
    Hamiltonian has eigenvalues ±i, no stabilizing solution), for the
    DARE an unstable but stabilizable open loop."""
    rng = np.random.RandomState(44 if discrete else 42)
    scale = 0.9 / np.sqrt(N) if discrete else 0.5
    a = (rng.randn(B, N, N) * scale).astype(np.float32)
    b = rng.randn(B, N, M).astype(np.float32)
    g = rng.randn(B, N, N)
    q = (np.einsum("bij,bkj->bik", g, g) / N + np.eye(N)).astype(np.float32)
    r = np.broadcast_to(np.eye(M), (B, M, M)).astype(np.float32).copy()
    if discrete:
        a[2] *= 2.2
    else:
        a[2] = 0.0
        a[2, 0, 1], a[2, 1, 0] = 1.0, -1.0
        a[2, 2:, 2:] = -np.eye(N - 2)
        b[2] = 0.0
        b[2, 2:, 0] = 1.0
        q[2] = 0.0
    return a, b, q, r


def test_care_matches_jax():
    from scipy.linalg import solve_continuous_are

    args = _riccati_batch(discrete=False)
    rj, rt = _run(jric.care_batched, tric.care_batched, *args)
    assert rt._fields == rj._fields
    _exact(rt.ok, rj.ok)
    assert rt.ok.tolist() == [True, True, False]
    _close(rt.X, rj.X, lanes=(0, 1))
    for i in (0, 1):
        want = solve_continuous_are(*(x[i].astype(np.float64) for x in args))
        assert np.abs(rt.X[i].double().numpy() - want).max() <= TOL * np.abs(
            want).max()
        assert float(rt.resid[i]) < 1e-3


def test_dare_matches_jax():
    from scipy.linalg import solve_discrete_are

    args = _riccati_batch(discrete=True)
    rj, rt = _run(jric.dare_batched, tric.dare_batched, *args)
    assert rt._fields == rj._fields
    _exact(rt.ok, rj.ok)
    assert bool(rt.ok.all())
    assert int(rt.iters) == int(rj.iters)
    _close(rt.X, rj.X)
    for i in range(B):
        want = solve_discrete_are(*(x[i].astype(np.float64) for x in args))
        assert np.abs(rt.X[i].double().numpy() - want).max() <= TOL * np.abs(
            want).max()
