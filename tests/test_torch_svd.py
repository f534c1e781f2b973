"""The port's QDWH polar decomposition and SVD
(``linalg_solver_tpu_torch.ops.svd``) against the JAX package's
``ops.svd``, fed the same numpy inputs.

Singular values within 1e-5·σmax; U and V column by column within 1e-5
after aligning each column's sign (the eigensolvers choose signs
freely; the inputs' singular values are simple), but for the null
direction of the rank-deficient lane, which is not determined; ``ok``
and the SVD rank exactly, a NaN lane included (NaN in both, where
torch's ``eigh`` would raise); the polar factors (``up`` where it is
unique), pseudoinverse and 2-norm condition within 1e-5; the adjoint
within 1e-4 of ``jax.vjp``'s, the port's
cotangents of U and V sign-aligned the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import svd as jsvd
from linalg_solver_tpu_torch.ops import svd as tsvd

RTOL = 1e-5
SHAPES = [(10, 6), (6, 10)]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.abs(got[fin] - want[fin]).max() <= rtol * max(
        np.abs(want[fin]).max(), 1.0)


def _batch(m, n, seed=0):
    """``[3, m, n]``; lane 2 of rank min(m, n) − 1."""
    a = np.random.RandomState(seed + m).randn(3, m, n).astype(np.float32)
    if m >= n:
        a[2, :, 0] = a[2, :, 1]
    else:
        a[2, 0] = a[2, 1]
    return a


def _signs(U, Uj):
    return np.sign((U * Uj).sum(axis=1))[:, None, :]


@pytest.mark.parametrize("m,n", SHAPES)
def test_svd_matches_jax(m, n):
    a = _batch(m, n)
    rj = jsvd.svd_batched(jnp.asarray(a))
    rt = tsvd.svd_batched(torch.from_numpy(a))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    s, sj = rt.s.numpy(), np.asarray(rj.s)
    assert np.abs(s - sj).max() <= RTOL * sj[:, 0].max()
    # lane 2's null direction (its last column) is not determined
    Uj, Vj = np.asarray(rj.U), np.asarray(rj.V)
    sg = _signs(rt.U.numpy(), Uj)
    for got, want in ((rt.U.numpy() * sg, Uj), (rt.V.numpy() * sg, Vj)):
        _close(got[:2], want[:2])
        _close(got[2, :, :-1], want[2, :, :-1])


@pytest.mark.parametrize("what", ["polar", "pinv", "cond2", "rank"])
def test_polar_pinv_cond_rank_match_jax(what):
    a = _batch(10, 6, seed=1)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    if what == "polar":
        rj, rt = jsvd.polar_batched(aj), tsvd.polar_batched(at)
        np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
        # the polar factor of the rank-deficient lane 2 is not unique
        _close(rt.up[:2], np.asarray(rj.up)[:2])
        _close(rt.H, rj.H)
    elif what == "pinv":
        _close(tsvd.pinv_batched(at), jsvd.pinv_batched(aj))
    elif what == "cond2":
        _close(tsvd.cond2_batched(at[:2]), jsvd.cond2_batched(aj[:2]))
    else:
        got = tsvd.rank_svd_batched(at)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jsvd.rank_svd_batched(aj)))
        assert got.tolist() == [6, 6, 5]


def test_a_nan_lane_is_nan_and_not_ok_in_both():
    a = _batch(10, 6, seed=2)
    a[1, 3, 2] = np.nan
    rj = jsvd.svd_batched(jnp.asarray(a))
    rt = tsvd.svd_batched(torch.from_numpy(a))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert rt.ok.tolist() == [True, False, True]
    for f in ("U", "s", "V"):
        np.testing.assert_array_equal(np.isnan(getattr(rt, f).numpy()),
                                      np.isnan(np.asarray(getattr(rj, f))))
    _close(rt.s[[0, 2]], np.asarray(rj.s)[[0, 2]])


@pytest.mark.parametrize("m,n", SHAPES)
def test_svd_vjp_matches_jax(m, n):
    a = _batch(m, n, seed=3)[:2]
    k = min(m, n)
    rng = np.random.RandomState(9)
    gU = rng.randn(2, m, k).astype(np.float32)
    gs = rng.randn(2, k).astype(np.float32)
    gV = rng.randn(2, n, k).astype(np.float32)
    out, vjp = jax.vjp(lambda x: tuple(jsvd.svd_batched(x)[:3]),
                       jnp.asarray(a))
    (want,) = vjp((jnp.asarray(gU), jnp.asarray(gs), jnp.asarray(gV)))
    at = torch.tensor(a, requires_grad=True)
    U, s, V, _ = tsvd.svd_batched(at)
    sg = _signs(U.detach().numpy(), np.asarray(out[0]))
    loss = ((U * torch.from_numpy(gU * sg)).sum()
            + (s * torch.from_numpy(gs)).sum()
            + (V * torch.from_numpy(gV * sg)).sum())
    (got,) = torch.autograd.grad(loss, at)
    _close(got, want, rtol=1e-4)


def test_an_unconverged_lane_is_the_reference_s():
    """Eight QDWH steps from l0 = 1e-3 do not reach a singular value far
    below it: on σmin/√(‖A‖₁‖A‖∞) ≈ 2.8e-6 and 8.4e-7 both packages
    leave U short of orthogonal by the same ‖UᵀU − I‖₂ (within 1 %)."""
    rng = np.random.RandomState(4)
    n = 24
    q1, _ = np.linalg.qr(rng.randn(2, n, n))
    q2, _ = np.linalg.qr(rng.randn(2, n, n))
    s = np.tile(np.linspace(1.0, 0.5, n), (2, 1))
    s[0, -1], s[1, -1] = 1e-5, 3e-6
    a = ((q1 * s[:, None, :]) @ q2.transpose(0, 2, 1)).astype(np.float32)

    def defect(U):
        U = np.asarray(U, np.float64)
        return np.array([np.abs(np.linalg.eigvalsh(u.T @ u - np.eye(n))).max()
                         for u in U])

    want = defect(jsvd.svd_batched(jnp.asarray(a)).U)
    got = defect(tsvd.svd_batched(torch.from_numpy(a)).U)
    assert np.all(want > 1e-3)
    assert np.all(np.abs(got - want) <= 1e-2 * want)
