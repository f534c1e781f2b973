"""The port's eigen stack (``linalg_solver_tpu_torch.ops.eigen``) against
the JAX package's ``ops.eigen``, fed the same numpy inputs (the JAX
generators' batches, as numpy, where a test needs structure).

Exact: algebraic and geometric multiplicities, Weyr characteristics,
``gen_mask``/``dim`` of eigenspaces, ``success``.  Values: ``charpoly``
coefficients within 1e-4 relative (to the largest coefficient);
``householder_qr`` and ``eigvals_qr`` (n ≤ 8, with a complex pair)
within 1e-4; eigenspace generators and ``P``, ``P⁻¹``, ``D`` within
1e-4 of their largest entry.  ``spectral_decompose_batched`` runs the
JAX side with ``interpret=True``, which reaches the Gauss–Jordan kernel
in interpret mode; the port's side runs kernel 3's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import eigen as je
from linalg_solver_tpu.ops import generate as jgen
from linalg_solver_tpu_torch.ops import eigen as te

RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1.0)


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _similar(vals, seed):
    """``P diag(vals) P⁻¹`` with Gaussian P, per row of ``vals``."""
    rng = np.random.RandomState(seed)
    B, n = vals.shape
    P = rng.randn(B, n, n)
    D = np.stack([np.diag(v) for v in vals])
    return np.einsum("bij,bjk,bkl->bil", P, D,
                     np.linalg.inv(P)).astype(np.float32)


def test_charpoly_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randint(-4, 5, (3, 5, 5)).astype(np.float32)
    want = np.asarray(je.charpoly_batched(jnp.asarray(a)))
    got = te.charpoly_batched(torch.from_numpy(a)).numpy()
    for i in range(3):
        _close(got[i], want[i])
        _close(got[i], np.poly(a[i].astype(np.float64)), rtol=1e-4)
    _close(te.charpoly(torch.from_numpy(a[0])).numpy(),
           np.asarray(je.charpoly(jnp.asarray(a[0]))))
    _close(te.charpoly_det_lambda(torch.from_numpy(a[1])).numpy(),
           np.asarray(je.charpoly_det_lambda(jnp.asarray(a[1]))))


def test_householder_qr_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.randn(6, 6).astype(np.float32)
    a[:, 2] = 0.0                       # a zero column: beta = 0 there
    qj, rj = je.householder_qr(jnp.asarray(a))
    qt, rt = te.householder_qr(torch.from_numpy(a))
    _close(qt.numpy(), qj)
    _close(rt.numpy(), rj)


def test_householder_qr_treats_a_subnormal_reflector_as_zero():
    """A column whose squared norm is subnormal: the reference's
    arithmetic flushes it to zero (no reflection), where 2/|v|² would
    overflow and turn R into NaN."""
    a = np.array([[1.0, 0.0, 0.0], [0.0, 4e-23, 0.0], [0.0, 3e-23, 1.0]],
                 np.float32)
    qj, rj = je.householder_qr(jnp.asarray(a))
    qt, rt = te.householder_qr(torch.from_numpy(a))
    assert bool(torch.isfinite(qt).all() and torch.isfinite(rt).all())
    _close(qt.numpy(), qj)
    _close(rt.numpy(), rj)


def _eig_inputs():
    """Three 6x6 matrices: real eigenvalues (3, 1, 1, −1, 0.5, 2) with a
    repeated one, a complex pair 1 ± 2i beside 3, −1, 0.5, −2, and a
    rotation-scaling block beside a Jordan block."""
    rng = np.random.RandomState(2)
    blocks = [np.diag([3.0, 1.0, 1.0, -1.0, 0.5, 2.0])]
    m = np.diag([3.0, 0.0, 0.0, -1.0, 0.5, -2.0])
    m[1:3, 1:3] = [[1.0, 2.0], [-2.0, 1.0]]
    blocks.append(m)
    m = np.diag([0.5, 0.5, 4.0, 4.0, -3.0, 1.5])
    m[0, 1], m[2, 3], m[3, 2] = 1.0, 1.0, -1.0
    blocks.append(m)
    X = rng.randn(3, 6, 6)
    return np.einsum("bij,bjk,bkl->bil", X, np.stack(blocks),
                     np.linalg.inv(X)).astype(np.float32)


def test_eigvals_qr_matches_jax_with_a_complex_pair():
    a = _eig_inputs()
    rj = jax.vmap(lambda m: je.eigvals_qr(m, iters=150))(jnp.asarray(a))
    rt = te.eigvals_qr_batched(torch.from_numpy(a), iters=150)
    _close(rt.real.numpy(), rj.real)
    _close(rt.imag.numpy(), rj.imag)
    assert sorted(np.round(rt.imag[1].numpy(), 3).tolist())[::5] == [-2.0,
                                                                      2.0]
    one = te.eigvals_qr(torch.from_numpy(a[1]), iters=150)
    _close(one.real.numpy(), rj.real[1])


def test_multiplicities_eigenspace_and_weyr_match_jax():
    lam = np.array([3.0, 3.0, 3.0, 1.0, 1.0, -2.0], np.float32)
    im = np.array([0, 0, 0, 0.5, -0.5, 0], np.float32)
    _exact(te.algebraic_multiplicities(torch.from_numpy(lam),
                                       torch.from_numpy(im), tol=1e-3),
           je.algebraic_multiplicities(jnp.asarray(lam), jnp.asarray(im),
                                       tol=1e-3))
    blocks = ((2.0, 3), (2.0, 1), (5.0, 2))
    a = np.array(jgen.jordan_batch(jax.random.PRNGKey(3), 2, blocks))
    for ev in (2.0, 5.0):
        sj = je.eigenspace(jnp.asarray(a[0]), jnp.float32(ev), tol=1e-4)
        st = te.eigenspace(torch.from_numpy(a[0]), ev, tol=1e-4)
        for f in ("gen_mask", "dim"):
            _exact(getattr(st, f), getattr(sj, f))
        _close(st.generators.numpy(), sj.generators)
        _exact(te.geometric_multiplicity(torch.from_numpy(a[0]), ev),
               je.geometric_multiplicity(jnp.asarray(a[0]), jnp.float32(ev)))
    evs = np.array([2.0, 2.0], np.float32)
    wj = jax.vmap(lambda m, e: je.weyr_characteristic(m, e, k_max=4))(
        jnp.asarray(a), jnp.asarray(evs))
    wt = te.weyr_characteristic_batched(torch.from_numpy(a),
                                        torch.from_numpy(evs), 4)
    _exact(wt, wj)
    assert wt.tolist() == [[2, 1, 1, 0]] * 2
    _exact(te.weyr_characteristic(torch.from_numpy(a[1]), 5.0, 3),
           je.weyr_characteristic(jnp.asarray(a[1]), jnp.float32(5.0), 3))


def test_diagonalize_matches_jax():
    """A unimodular ``diagonalizable_batch`` of the reference (success),
    one of its Jordan batches (defective: no success), as numpy."""
    good = np.array(jgen.diagonalizable_batch(jax.random.PRNGKey(4), 2,
                                              [1.0, 2.0, 2.0, -3.0]))
    bad = np.array(jgen.jordan_batch(jax.random.PRNGKey(1), 1,
                                     ((2.0, 2), (1.0, 2))))
    a = np.concatenate([good, bad])
    rj = jax.vmap(lambda m: je.diagonalize(m, iters=200, tol=3e-2))(
        jnp.asarray(a))
    rt = te.diagonalize_batched(torch.from_numpy(a), iters=200, tol=3e-2)
    _exact(rt.success, rj.success)
    assert rt.success.tolist() == [True, True, False]
    _exact(rt.alg_mult, rj.alg_mult)
    _close(rt.eigenvalues.numpy(), rj.eigenvalues)
    for f in ("P", "P_inv", "D"):
        for i in range(2):      # the defective lane's P_inv is NaN on both
            _close(getattr(rt, f)[i].numpy(), getattr(rj, f)[i])
    one = te.diagonalize(torch.from_numpy(a[0]), iters=200, tol=3e-2)
    _close(one.P.numpy(), rj.P[0])


def _decompose_both(a, vals, imag=None, **kw):
    imag = np.zeros_like(vals) if imag is None else imag
    rj = je.spectral_decompose_batched(
        jnp.asarray(a), jnp.asarray(vals), jnp.asarray(imag),
        interpret=True, **kw)
    rt = te.spectral_decompose_batched(
        torch.from_numpy(a), torch.from_numpy(vals), torch.from_numpy(imag),
        **kw)
    for f in ("alg_mult", "geom_mult", "success", "eigenvalues", "eig_imag"):
        _exact(getattr(rt, f), getattr(rj, f))
    for f in ("P", "P_inv", "D"):
        for i in range(a.shape[0]):
            x = np.asarray(getattr(rj, f)[i])
            if np.isfinite(x).all():
                _close(getattr(rt, f)[i].numpy(), x)
    return rt


def test_spectral_decompose_matches_jax():
    vals = np.array([[3, 3, 2, 2, 2, 1], [5, 4, 3, 2, 1, 0],
                     [1, 1, 1, 1, 1, 1], [4, 4, 2, 2, 1, 1]], np.float32)
    a = _similar(vals, seed=41)
    rt = _decompose_both(a, vals, tol=1e-3, space_tol=1e-3)
    assert rt.success.tolist() == [True] * 4
    assert rt.alg_mult[0].tolist() == [2, 2, 3, 3, 3, 1]
    # a bound below the true distinct count starves a cluster
    rt = _decompose_both(a[3:], vals[3:], max_distinct=2)
    assert rt.success.tolist() == [False]
    assert rt.geom_mult[0].tolist() == [2, 2, 2, 2, 0, 0]


def test_spectral_decompose_flags_defective_and_complex_like_jax():
    J = np.zeros((2, 3, 3), np.float32)
    J[0] = [[2, 1, 0], [0, 2, 0], [0, 0, 1]]        # defective at 2
    J[1] = [[0, -1, 0], [1, 0, 0], [0, 0, 3]]       # ±i beside 3
    vals = np.array([[2, 2, 1], [0, 0, 3]], np.float32)
    imag = np.array([[0, 0, 0], [1, -1, 0]], np.float32)
    rt = _decompose_both(J, vals, imag)
    assert rt.success.tolist() == [False, False]
    assert rt.geom_mult[0].tolist() == [1, 1, 1]
    assert rt.alg_mult[0].tolist() == [2, 2, 1]


@pytest.mark.parametrize("md", [None, 3])
def test_place_columns_is_the_one_hot_collect(md):
    """The index scatter that builds P puts cluster k's column t at
    column ``Σ_{k'<k} g_k' + t`` and drops what passes n, as the
    reference's one-hot scan does (here written out as that scan)."""
    rng = np.random.RandomState(5)
    bc, n = 3, 5
    K = n if md is None else md
    Q = torch.from_numpy(rng.randn(bc, K, n, n).astype(np.float32))
    g = torch.from_numpy(rng.randint(0, 4, (bc, K)))
    t = torch.arange(n)
    want = torch.zeros(bc, n, n)
    cnt = torch.zeros(bc, dtype=torch.long)
    for k in range(K):
        c_oh = (((t[None, :, None] + cnt[:, None, None]) == t[None, None, :])
                & (t[None, :, None] < g[:, k, None, None])).float()
        want = want + torch.einsum("bit,btc->bic", Q[:, k], c_oh)
        cnt = cnt + g[:, k]
    assert torch.equal(te._place_columns(Q, g), want)
