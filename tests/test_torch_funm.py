"""The port's matrix functions (``linalg_solver_tpu_torch.ops.funm``)
against the JAX package, fed the same numpy inputs.

Values within 1e-4 of the largest entry of the JAX package's; the flags
(``converged``, ``ok``), Newton steps, root counts and segment counts
exact.  ``expm_cond_batched`` with the JAX package's random start handed
over: within 1e-4 relative.  The gradient of ``expm_batched`` is in
``tests/test_torch_funm_grad.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import funm as jfm
from linalg_solver_tpu_torch.ops import funm as tfm

B, N = 3, 10
TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    for b in range(want.shape[0]):
        assert np.abs(got[b] - want[b]).max() <= tol * np.abs(want[b]).max()


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _right_half_plane(seed, n=N):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, n) + 3.0 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)


def _small(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, N) / np.sqrt(N)).astype(np.float32)


@pytest.mark.parametrize("scale", [0.25, 4.0])
def test_expm_matches_jax(scale):
    """Both branches: no squaring, and every lane squaring."""
    a = (scale * np.random.RandomState(1).randn(B, N, N)).astype(np.float32)
    _close(tfm.expm_batched(_t(a)), jfm.expm_batched(jnp.asarray(a)))


def test_sqrtm_matches_jax():
    a = _right_half_plane(2)
    rj, rt = jfm.sqrtm_batched(jnp.asarray(a)), tfm.sqrtm_batched(_t(a))
    assert rt._fields == rj._fields
    _close(rt.Y, rj.Y)
    _close(rt.Yinv, rj.Yinv)
    _exact(rt.converged, rj.converged)
    assert int(rt.iters) == int(rj.iters)


def test_logm_and_powm_match_jax():
    a = _right_half_plane(3)
    rj, rt = jfm.logm_batched(jnp.asarray(a)), tfm.logm_batched(_t(a))
    assert rt._fields == rj._fields
    _close(rt.L, rj.L)
    _exact(rt.converged, rj.converged)
    _exact(rt.roots, rj.roots)
    for p in (0.5, -0.3):
        pj, okj = jfm.powm_batched(jnp.asarray(a), p)
        pt, okt = tfm.powm_batched(_t(a), p)
        _close(pt, pj)
        _exact(okt, okj)


def test_logm_flags_a_negative_real_eigenvalue():
    """A lane with an eigenvalue on the negative real axis is outside the
    principal logarithm's domain: flagged by both packages alike."""
    a = _right_half_plane(4)
    a[1] = np.diag(np.r_[-2.0, np.linspace(1.0, 3.0, N - 1)]).astype(
        np.float32)
    rj, rt = jfm.logm_batched(jnp.asarray(a)), tfm.logm_batched(_t(a))
    _exact(rt.converged, rj.converged)
    assert not bool(rt.converged[1])
    good = [0, 2]
    _close(rt.L[good], np.asarray(rj.L)[good])


@pytest.mark.parametrize("name,p", [("sqrtm_spd_batched", None),
                                    ("logm_spd_batched", None),
                                    ("powm_spd_batched", -0.5)])
def test_spd_forms_match_jax(name, p):
    g = np.random.RandomState(5).randn(B, N, N)
    s = (g @ g.transpose(0, 2, 1) / N + 0.1 * np.eye(N)).astype(np.float32)
    args = () if p is None else (p,)
    _close(getattr(tfm, name)(_t(s), *args),
           getattr(jfm, name)(jnp.asarray(s), *args))


@pytest.mark.parametrize("name", ["cosm_batched", "sinm_batched",
                                  "tanm_batched", "coshm_batched",
                                  "sinhm_batched", "tanhm_batched"])
def test_trig_and_hyperbolic_match_jax(name):
    a = _small(6)
    _close(getattr(tfm, name)(_t(a)), getattr(jfm, name)(jnp.asarray(a)))


def test_funm_matches_jax():
    rng = np.random.RandomState(7)
    a = (rng.randn(B, N, N) / np.sqrt(N)
         + np.diag(np.linspace(1.0, 4.0, N))).astype(np.float32)
    for fj, ft in ((jnp.exp, torch.exp),
                   (lambda z: z * jnp.exp(-z) + jnp.cos(z),
                    lambda z: z * torch.exp(-z) + torch.cos(z))):
        rj, rt = jfm.funm_batched(jnp.asarray(a), fj), tfm.funm_batched(
            _t(a), ft)
        assert rt._fields == rj._fields
        _close(rt.F, rj.F)
        _exact(rt.ok, rj.ok)
        assert float(rt.imag_max.max()) < 1e-4
        assert float(rt.resid.max()) < 1e-5


def test_funm_inverts_v_through_the_real_embedding(monkeypatch):
    """``V⁻¹`` comes from ``dispatch.inverse_batched`` on the real 2n
    embedding of V, as the reference's ``complexlin`` inverts it, and
    reconstructs A."""
    from linalg_solver_tpu_torch.ops import dispatch

    seen, orig = [], dispatch.inverse_batched

    def rec(m, *args, **kw):
        seen.append(tuple(m.shape))
        return orig(m, *args, **kw)

    monkeypatch.setattr(dispatch, "inverse_batched", rec)
    a = _right_half_plane(9)
    res = tfm.funm_batched(_t(a), torch.exp)
    assert seen == [(B, 2 * N, 2 * N)]
    assert float(res.resid.max()) < 1e-5 and bool(res.ok.all())


def test_expm_frechet_matches_jax():
    a = _small(8)
    e = np.random.RandomState(9).randn(B, N, N).astype(np.float32)
    e[2] = 0.0                       # a zero direction: L exactly 0
    rj = jfm.expm_frechet_batched(jnp.asarray(a), jnp.asarray(e))
    rt = tfm.expm_frechet_batched(_t(a), _t(e))
    assert rt._fields == rj._fields
    _close(rt.expm, rj.expm)
    _close(rt.L[:2], np.asarray(rj.L)[:2])
    assert float(rt.L[2].abs().max()) == 0.0


def test_expm_cond_matches_jax():
    a = _small(10)
    e0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (B, N, N),
                                    jnp.float32))
    kj, sj = jfm.expm_cond_batched(jnp.asarray(a))
    kt, st = tfm.expm_cond_batched(_t(a), e0=e0)
    for got, want in ((kt, kj), (st, sj)):
        want = np.asarray(want, np.float64)
        assert (np.abs(got.double().numpy() - want) <= TOL * want).all()
    # a seeded generator start: the same draw twice
    runs = [tfm.expm_cond_batched(_t(a), generator=torch.Generator()
                                  .manual_seed(2))[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("t", [1.0, -0.5])
def test_expm_multiply_matches_jax(t):
    a = (3.0 * np.random.RandomState(11).randn(B, N, N)).astype(np.float32)
    a[0] *= 0.01                     # lanes with different segment counts
    v = np.random.RandomState(12).randn(B, N).astype(np.float32)
    rj = jfm.expm_multiply_batched(jnp.asarray(a), jnp.asarray(v), t=t)
    rt = tfm.expm_multiply_batched(_t(a), _t(v), t=t)
    assert rt._fields == rj._fields
    _close(rt.x, rj.x)
    _exact(rt.segments, rj.segments)
    _exact(rt.ok, rj.ok)


def test_expm_multiply_matvec_and_segment_cap():
    a = (3.0 * np.random.RandomState(13).randn(B, N, N)).astype(np.float32)
    v = np.random.RandomState(14).randn(B, N).astype(np.float32)
    at = _t(a)
    norm = at.abs().sum(dim=1).amax(dim=1)
    rt = tfm.expm_multiply_matvec(lambda w: (at @ w[:, :, None])[:, :, 0],
                                  _t(v), norm, max_segments=4)
    rj = jfm.expm_multiply_matvec(
        lambda w: jnp.einsum("bij,bj->bi", jnp.asarray(a), w),
        jnp.asarray(v), jnp.asarray(norm.numpy()), max_segments=4)
    _close(rt.x, rj.x)
    _exact(rt.segments, rj.segments)
    _exact(rt.ok, rj.ok)
    assert not bool(rt.ok.all()) and bool(torch.isfinite(rt.x).all())
