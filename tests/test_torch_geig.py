"""The port's generalized and polynomial eigenproblems
(``linalg_solver_tpu_torch.ops.geig``, ``ops.quadeig``) against the JAX
package, fed the same numpy inputs.

Exact: ``ok``, ``finite`` and ``valid`` (through the one-to-one
eigenvalue matching, as the two Schur solvers order their spectra
differently).  Values: eigenvalues within 1e-5 of the lane's largest
finite modulus, eigenvectors up to a unit phase a column
(``|v_portᴴ v_jax| ≥ 1 − 1e-4``; for the symmetric-definite problem up to
sign, ``|v_portᵀ B v_jax| ≥ 1 − 1e-4``), the shift and ``rcond``
estimates within 1e-5 relative.  Every pencil is [3, 12, 12] (the
quadratic ones n = 6, the cubic n = 4: their linearizations are 12 × 12
as well), so each JAX function compiles once.  Edge cases as lanes: a
non-SPD B, a singular B, singular pencils with infinite eigenvalues, a
rotation block (complex pencil eigenvalues), a singular mass."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from linalg_solver_tpu.ops import geig as jgeig
from linalg_solver_tpu.ops import quadeig as jquad
from linalg_solver_tpu_torch.ops import geig as tgeig
from linalg_solver_tpu_torch.ops import quadeig as tquad

B, N = 3, 12
TOL_EIG = 1e-5
TOL_VEC = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _lam(res):
    return (np.asarray(res.real, np.float64)
            + 1j * np.asarray(res.imag, np.float64))


def _vecs(res):
    return (np.asarray(res.vectors_real, np.float64)
            + 1j * np.asarray(res.vectors_imag, np.float64))


def _truth(a, b):
    """Each lane's finite pencil eigenvalues in float64 (scipy's QZ; its
    infinite ones, huge but finite at float64 roundoff, dropped)."""
    from scipy.linalg import eig

    out = []
    for x, y in zip(a, b):
        w = eig(x.astype(np.float64), y.astype(np.float64), right=False)
        out.append(w[np.isfinite(w) & (np.abs(w) < 1e4)])
    return out


def _dev(want, got):
    """Largest distance under the one-to-one matching."""
    r, c = linear_sum_assignment(np.abs(want[:, None] - got[None, :]))
    return np.abs(want[r] - got[c]).max()


def _hold_pencil(rj, rt, lanes, truth, vectors=True):
    """Flags exactly; the finite eigenvalues and eigenvectors through the
    one-to-one matching of each lane's finite eigenvalues (the infinite
    ones are counted).  Eigenvalues: the port's within 1e-5 of the lane's
    largest modulus of the float64 ones, or, where the JAX package is
    farther from them than that (a pencil reached through an ill-
    conditioned A − σB), within 1.5× the JAX package's distance."""
    np.testing.assert_array_equal(np.asarray(rj.ok), rt.ok.numpy())
    lj, lt = _lam(rj), _lam(rt)
    Vj, Vt = _vecs(rj), _vecs(rt)
    fj = (np.asarray(rj.finite) if hasattr(rj, "finite")
          else np.ones(lj.shape, bool))
    ft = rt.finite.numpy() if hasattr(rt, "finite") else fj
    for b in lanes:
        assert fj[b].sum() == ft[b].sum() == len(truth[b])
        dj, dt = _dev(truth[b], lj[b][fj[b]]), _dev(truth[b], lt[b][ft[b]])
        assert dt <= max(TOL_EIG * np.abs(truth[b]).max(), 1.5 * dj)
        ij, it = np.flatnonzero(fj[b]), np.flatnonzero(ft[b])
        r, c = linear_sum_assignment(
            np.abs(lj[b][ij][:, None] - lt[b][it][None, :]))
        r, c = ij[r], it[c]
        np.testing.assert_array_equal(np.asarray(rj.valid)[b][r],
                                      rt.valid.numpy()[b][c])
        if not vectors:
            continue
        keep = np.asarray(rj.valid)[b][r]
        vj, vt = Vj[b][:, r], Vt[b][:, c]
        overlap = np.abs((vj.conj() * vt).sum(0)) / (
            np.linalg.norm(vj, axis=0) * np.linalg.norm(vt, axis=0))
        assert overlap[keep].min() >= 1 - TOL_VEC


def _spd(rng, n):
    g = rng.randn(B, n, n)
    return (np.einsum("bik,bjk->bij", g, g) + 0.5 * np.eye(n)).astype(
        np.float32)


def test_eigh_generalized_matches_jax():
    """Lanes 0-1 as the reference's scipy test, lane 2's B not SPD
    (``test_non_spd_b_flagged``): ok False and NaN there in both."""
    from scipy.linalg import eigh

    rng = np.random.RandomState(1)
    a = rng.randn(B, N, N).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    b = _spd(rng, N)
    b[2] -= 200.0 * np.eye(N, dtype=np.float32)
    rj = jgeig.eigh_generalized_batched(jnp.asarray(a), jnp.asarray(b))
    rt = tgeig.eigh_generalized_batched(_t(a), _t(b))
    assert rt._fields == rj._fields
    np.testing.assert_array_equal(np.asarray(rj.ok), rt.ok.numpy())
    assert rt.ok.tolist() == [True, True, False]
    for res in (rj, rt):
        assert np.isnan(np.asarray(res.w)[2]).all()
        assert np.isnan(np.asarray(res.V)[2]).all()
    w, V = rt.w.double().numpy(), rt.V.double().numpy()
    wj, Vj = np.asarray(rj.w, np.float64), np.asarray(rj.V, np.float64)
    for i in (0, 1):
        assert np.abs(w[i] - wj[i]).max() <= TOL_EIG * np.abs(wj[i]).max()
        b64 = b[i].astype(np.float64)
        overlap = np.abs(np.einsum("ij,ik,kj->j", V[i], b64, Vj[i]))
        assert overlap.min() >= 1 - TOL_VEC
        assert np.abs(V[i].T @ b64 @ V[i] - np.eye(N)).max() <= 1e-4
        want = eigh(a[i].astype(np.float64), b64, eigvals_only=True)
        assert np.abs(w[i] - want).max() <= 1e-4 * max(np.abs(want).max(), 1)


def test_eig_generalized_matches_jax():
    """Lanes 0-1 invertible B (the reference's scipy test), lane 2 a B
    with a zero row: rcond 0 and ok False in both."""
    from scipy.linalg import eig

    rng = np.random.RandomState(5)
    a = rng.randn(B, N, N).astype(np.float32)
    b = (rng.randn(B, N, N) + 4.0 * np.sqrt(N) * np.eye(N)).astype(
        np.float32)
    b[2, 3] = 0.0
    rj = jgeig.eig_generalized_batched(jnp.asarray(a), jnp.asarray(b))
    rt = tgeig.eig_generalized_batched(_t(a), _t(b))
    assert rt._fields == rj._fields
    assert rt.ok.tolist() == [True, True, False]
    _hold_pencil(rj, rt, (0, 1), _truth(a, b))
    rc, rcj = rt.rcond_b.double().numpy(), np.asarray(rj.rcond_b, np.float64)
    assert np.abs(rc - rcj).max() <= 1e-5 * rcj.max() and rc[2] == 0.0
    lam = _lam(rt)
    for i in (0, 1):
        want = list(eig(a[i].astype(np.float64), b[i].astype(np.float64),
                        right=False))
        for g in lam[i]:
            j = int(np.argmin(np.abs(np.asarray(want) - g)))
            assert abs(want.pop(j) - g) < 1e-3
        true = 1.0 / np.linalg.cond(b[i].astype(np.float64), 1)
        assert true / 10 <= rc[i] <= true * 10


def _singular_pencil(rng, n_inf, finite_lams=None):
    """A regular pencil with ``n − n_inf`` known finite eigenvalues and
    ``n_inf`` infinite ones, scrambled by an equivalence (the reference's
    ``_singular_pencil``)."""
    nf = N - n_inf
    if finite_lams is None:
        finite_lams = np.linspace(-3.0, 7.0, nf)
    D_A = np.diag(np.concatenate([finite_lams, np.ones(n_inf)]))
    D_B = np.diag(np.concatenate([np.ones(nf), np.zeros(n_inf)]))
    P = rng.randn(N, N) * 0.4 + np.eye(N)
    Q = rng.randn(N, N) * 0.4 + np.eye(N)
    return (P @ D_A @ Q).astype(np.float32), (P @ D_B @ Q).astype(np.float32)


def _shifted_batch():
    """Lane 0: 3 infinite eigenvalues; lane 1: 1 infinite and a rotation
    block (a complex pair 3 ± 2i); lane 2: an invertible B."""
    rng = np.random.RandomState(30)
    a = np.empty((B, N, N), np.float32)
    b = np.empty((B, N, N), np.float32)
    a[0], b[0] = _singular_pencil(rng, 3)
    lams = np.linspace(-2.0, 5.0, N - 1)
    a[1], b[1] = _singular_pencil(rng, 1, lams)
    P = rng.randn(N, N) * 0.3 + np.eye(N)
    Q = rng.randn(N, N) * 0.3 + np.eye(N)
    D = np.diag(np.concatenate([lams, [1.0]]))
    D[0:2, 0:2] = [[3.0, -2.0], [2.0, 3.0]]
    Db = np.eye(N)
    Db[-1, -1] = 0.0
    a[1], b[1] = P @ D @ Q, P @ Db @ Q
    a[2] = rng.randn(N, N)
    b[2] = rng.randn(N, N) + 4.0 * np.sqrt(N) * np.eye(N)
    return a, b


@pytest.mark.parametrize("sigma", [None, 0.3])
def test_eig_generalized_shifted_matches_jax(sigma):
    a, b = _shifted_batch()
    rj = jgeig.eig_generalized_shifted_batched(jnp.asarray(a),
                                               jnp.asarray(b), sigma=sigma)
    rt = tgeig.eig_generalized_shifted_batched(_t(a), _t(b), sigma=sigma)
    assert rt._fields == rj._fields
    assert rt.finite.sum(1).tolist() == [N - 3, N - 1, N]
    _hold_pencil(rj, rt, range(B), _truth(a, b))
    for f in ("sigma", "rcond_shift"):
        x, y = np.asarray(getattr(rj, f)), getattr(rt, f).numpy()
        assert np.abs(y - x).max() <= 1e-5 * np.abs(x).max()
    assert np.isinf(rt.real.numpy()[~rt.finite.numpy()]).all()
    assert (rt.imag.numpy()[~rt.finite.numpy()] == 0).all()
    lam = _lam(rt)[1][rt.finite[1].numpy()]
    cplx = np.sort_complex(lam[np.abs(lam.imag) > 1e-3])
    assert np.abs(cplx - [3.0 - 2.0j, 3.0 + 2.0j]).max() < 5e-3


def test_shifted_ladder_on_a_singular_pencil():
    """Lane 0's A and B share a null vector (det(A − λB) ≡ 0): no rung of
    the shift ladder gives an invertible A − σB, so the lane ends on the
    last rung with rcond 0 and ok False, in both packages alike; the
    other lanes land on the first rung."""
    a, b = _shifted_batch()
    a[0, :, 0] = 0.0
    b[0, :, 0] = 0.0
    rj = jgeig.eig_generalized_shifted_batched(jnp.asarray(a),
                                               jnp.asarray(b))
    rt = tgeig.eig_generalized_shifted_batched(_t(a), _t(b))
    assert rt.ok.tolist() == [False, True, True]
    np.testing.assert_array_equal(np.asarray(rj.ok), rt.ok.numpy())
    np.testing.assert_allclose(rt.sigma.numpy(), np.asarray(rj.sigma),
                               rtol=1e-5)
    rho = np.abs(a).sum(1).max(1) / np.abs(b).sum(1).max(1)
    np.testing.assert_allclose(rt.sigma.numpy(),
                               [0.276393 * rho[0], 1.077351 * rho[1],
                                1.077351 * rho[2]], rtol=1e-5)
    assert float(rt.rcond_shift[0]) == 0.0
    # beside lane 0's NaN eigensolve, lane 1's eigenvectors come out far
    # less accurate in both packages than float64's: its eigenvalues and
    # flags are held, its vectors not
    _hold_pencil(rj, rt, (1,), _truth(a, b), vectors=False)
    _hold_pencil(rj, rt, (2,), _truth(a, b))


def _linearize(coeffs):
    """The first companion pencil (A, B) of ``Σ λ^i coeffs[i]``, float64."""
    d, (bsz, n, _) = len(coeffs) - 1, coeffs[0].shape
    A = np.zeros((bsz, d * n, d * n))
    Bm = np.tile(np.eye(d * n), (bsz, 1, 1))
    A[:, :-n, n:] = np.eye((d - 1) * n)
    A[:, -n:, :] = -np.concatenate(coeffs[:d], 2)
    Bm[:, -n:, -n:] = coeffs[d]
    return A, Bm


def _quadratic_batch():
    """Equivalence-scrambled diagonal quadratic pencils at n = 6 (the
    reference's ``diagonal_quadratic``): lane 0 regular, lane 1 with a
    singular mass (one infinite eigenvalue), lane 2 regular, another seed."""
    mm = np.array([1.0, 2.0, 1.0, 0.5, 1.0, 3.0])
    cc = np.array([0.5, 1.0, 3.0, 0.2, 2.0, 0.1])
    kk = np.array([4.0, 9.0, 1.0, 6.0, 5.0, 2.0])
    out = np.empty((3, B, 6, 6), np.float32)
    for lane, (seed, zero) in enumerate(((0, None), (0, 3), (1, None))):
        rng = np.random.RandomState(seed)
        m = mm.copy()
        if zero is not None:
            m[zero] = 0.0
        P = rng.randn(6, 6) * 0.3 + np.eye(6)
        Q = rng.randn(6, 6) * 0.3 + np.eye(6)
        for k, d in enumerate((m, cc, kk)):
            out[k, lane] = P @ np.diag(d) @ Q
    return out


def test_quadeig_matches_jax():
    m, c, k = _quadratic_batch()
    rj = jquad.quadeig_batched(*map(jnp.asarray, (m, c, k)))
    rt = tquad.quadeig_batched(*map(_t, (m, c, k)))
    assert rt._fields == rj._fields
    assert rt.finite.sum(1).tolist() == [12, 11, 12]
    assert bool(rt.ok.all())
    _hold_pencil(rj, rt, range(B), _truth(*_linearize([k, c, m])))
    assert float(rt.resid.max()) < 1e-4
    assert float(np.asarray(rj.resid).max()) < 1e-4


def test_polyeig_cubic_matches_jax():
    """Degree 3 at n = 4 (a 12 × 12 linearization), Gaussian coefficients
    with a well-conditioned leading one."""
    rng = np.random.RandomState(7)
    coeffs = [rng.randn(B, 4, 4).astype(np.float32) for _ in range(4)]
    coeffs[3] += 3.0 * np.eye(4, dtype=np.float32)
    rj = jquad.polyeig_batched([jnp.asarray(x) for x in coeffs])
    rt = tquad.polyeig_batched([_t(x) for x in coeffs])
    assert bool(rt.ok.all()) and bool(rt.finite.all())
    _hold_pencil(rj, rt, range(B), _truth(*_linearize(coeffs)))
    np.testing.assert_array_equal(np.asarray(rj.finite), rt.finite.numpy())
    assert float(rt.resid.max()) < 1e-4
    with pytest.raises(ValueError):
        tquad.polyeig_batched([_t(coeffs[0])])
