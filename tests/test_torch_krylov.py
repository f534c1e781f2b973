"""The port's Krylov solvers (``linalg_solver_tpu_torch.ops.krylov``)
against the JAX package's ``ops.krylov`` on the same numpy inputs.

Solutions agree to 1e-4 of each lane's largest entry (the two packages
sum their inner products in different orders, and a Krylov iterate
carries that rounding times the system's condition), ``converged`` flags
exactly, ``iters`` exactly (the JAX package's ``k``: iterations in which
some lane was live), residuals to 5e-6 absolute (both at the f32 floor,
tol = 100 ulp).  One CG batch has a lane that stalls at ``max_iters``
while the others finish, another a NaN lane.  The chunked loop reads
the host at most ⌈iters / chunk⌉ + 1 times, and iterations past the stop
leave the state bitwise as it was (the same solve at chunk 1 and 16)."""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import krylov as jk
from linalg_solver_tpu_torch.ops import krylov

N = 32


def _spd(B, n, seed, cond=10.0):
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(B, n, n))
    lam = np.geomspace(1.0, cond, n)[None, :] * (1.0 + 0.01 * rng.rand(B, n))
    return np.einsum("bij,bj,bkj->bik", Q, lam, Q).astype(np.float32)


def _general(B, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, n) + 3.0 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)


def _rhs(B, n, seed):
    return np.random.RandomState(seed).randn(B, n).astype(np.float32)


def _agree(rt, rj, lanes=None):
    x, xj = rt.x.numpy(), np.asarray(rj.x)
    lanes = range(x.shape[0]) if lanes is None else lanes
    for i in lanes:
        err = np.abs(x[i] - xj[i]).max()
        assert err <= 1e-4 * np.abs(xj[i]).max(), (i, err)
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    assert int(rt.iters) == int(rj.iters)
    assert rt.iters.dtype == torch.int32 and rt.iters.dim() == 0
    res, resj = rt.resnorm.numpy(), np.asarray(rj.resnorm)
    for i in lanes:
        assert abs(res[i] - resj[i]) <= 5e-6, (i, res[i], resj[i])


def _t(x):
    return torch.from_numpy(x)


def test_cg_one_lane_stalls_while_the_others_finish():
    """Lane 2 has condition 1e4 and cannot reach tol in 24 iterations:
    the loop runs to ``max_iters``, the finished lanes stay frozen."""
    a = _spd(4, N, seed=1)
    a[2] = _spd(1, N, seed=2, cond=1e4)[0]
    b = _rhs(4, N, 3)
    rt = krylov.cg_batched(_t(a), _t(b), max_iters=24)
    rj = jk.cg_batched(jnp.asarray(a), jnp.asarray(b), max_iters=24)
    assert rt.converged.tolist() == [True, True, False, True]
    assert int(rt.iters) == 24
    # the stalled lane's iterate is 24 steps of rounding-driven CG on
    # condition 1e4: both far from tol, not from each other's rounding
    _agree(rt, rj, lanes=[0, 1, 3])
    assert rt.resnorm[2] > 1e-2 and np.asarray(rj.resnorm)[2] > 1e-2


def test_cg_nan_lane_and_early_stop():
    """A NaN lane never converges, so the loop runs to 2n; the other
    lanes agree with the JAX package.  Without it the loop stops early,
    at the JAX package's count."""
    a = _spd(3, N, seed=4)
    b = _rhs(3, N, 5)
    rt = krylov.cg_batched(_t(a), _t(b))
    rj = jk.cg_batched(jnp.asarray(a), jnp.asarray(b))
    assert bool(rt.converged.all()) and int(rt.iters) < 2 * N
    _agree(rt, rj)
    a[1, 3, 4] = np.nan
    rt = krylov.cg_batched(_t(a), _t(b), jacobi=True)
    rj = jk.cg_batched(jnp.asarray(a), jnp.asarray(b), jacobi=True)
    assert rt.converged.tolist() == [True, False, True]
    assert int(rt.iters) == int(rj.iters) == 2 * N
    assert np.isnan(rt.x[1].numpy()).all()
    _agree(rt, rj, lanes=[0, 2])


def test_bicgstab_matches_jax():
    a = _general(4, N, seed=6)
    b = _rhs(4, N, 7)
    rt = krylov.bicgstab_batched(_t(a), _t(b))
    rj = jk.bicgstab_batched(jnp.asarray(a), jnp.asarray(b))
    assert bool(rt.converged.all())
    _agree(rt, rj)


@pytest.mark.parametrize("jacobi", [False, True])
def test_gmres_matches_jax(jacobi):
    a = _general(4, N, seed=8)
    a[1] *= np.geomspace(1.0, 100.0, N)[:, None].astype(np.float32)
    b = _rhs(4, N, 9)
    rt = krylov.gmres_batched(_t(a), _t(b), restart=8, max_restarts=6,
                              jacobi=jacobi)
    rj = jk.gmres_batched(jnp.asarray(a), jnp.asarray(b), restart=8,
                          max_restarts=6, jacobi=jacobi)
    assert int(rt.iters) % 8 == 0
    _agree(rt, rj)


@pytest.mark.parametrize("jacobi", [False, True])
def test_minres_matches_jax(jacobi):
    """Without Jacobi an indefinite system (eigenvalues ±[1, 3]); with it
    an SPD one with rows scaled over 1 … 30.  On a harder indefinite
    spectrum (±[1, 10] at n = 32, where MINRES needs 45–47 steps, past n)
    the Lanczos vectors lose orthogonality and the two packages stop up
    to 2 iterations apart, converged on both; these converge in fewer
    than n steps, where the counts agree."""
    rng = np.random.RandomState(10)
    if jacobi:
        d = np.geomspace(1.0, 30.0, N).astype(np.float32)
        a = _spd(3, N, seed=10) * d[:, None] * d[None, :]
    else:
        Q, _ = np.linalg.qr(rng.randn(3, N, N))
        lam = np.concatenate([-np.geomspace(1, 3, N // 2),
                              np.geomspace(1, 3, N // 2)])
        a = np.einsum("bij,j,bkj->bik", Q, lam, Q).astype(np.float32)
    b = _rhs(3, N, 11)
    rt = krylov.minres_batched(_t(a), _t(b), jacobi=jacobi)
    rj = jk.minres_batched(jnp.asarray(a), jnp.asarray(b), jacobi=jacobi)
    # with Jacobi the recurrence stops on the scaled system; the true
    # residual of the badly scaled one stays under the JAX test's 1e-3,
    # not under 4·tol, on both packages (converged False alike)
    assert bool(rt.converged.all()) or jacobi
    assert float(rt.resnorm.max()) < 1e-3
    _agree(rt, rj)


@pytest.mark.parametrize("damp", [0.0, 0.5])
def test_lsqr_matches_jax(damp):
    rng = np.random.RandomState(12)
    a = rng.randn(3, 48, N).astype(np.float32)
    b = rng.randn(3, 48).astype(np.float32)
    rt = krylov.lsqr_batched(_t(a), _t(b), damp=damp)
    rj = jk.lsqr_batched(jnp.asarray(a), jnp.asarray(b), damp=damp)
    assert bool(rt.converged.all())
    _agree(rt, rj)
    assert np.abs(rt.atresnorm.numpy() - np.asarray(rj.atresnorm)).max() \
        <= 5e-6
    if damp == 0.0:
        x64 = np.stack([np.linalg.lstsq(m, v, rcond=None)[0]
                        for m, v in zip(a.astype(np.float64), b)])
        err = np.abs(rt.x.numpy() - x64).max(axis=1)
        assert (err <= 5e-4 * np.abs(x64).max(axis=1)).all()


def test_chunks_read_the_host_rarely_and_freeze_past_the_stop(monkeypatch):
    """The matrix-free CG on a closure: at chunk 16 the loop reads the
    host at most ⌈iters / 16⌉ + 1 times; at chunk 1 it reads once an
    iteration, and the solutions are bitwise equal, so the gated
    iterations past the stop changed nothing."""
    a = _t(_spd(4, N, seed=13))
    b = _t(_rhs(4, N, 14))
    mv = krylov._mv_dense(a)
    krylov.reset_host_reads()
    r16 = krylov.cg_matvec(mv, b)
    iters = int(r16.iters)
    assert 0 < iters < 2 * N
    assert krylov.HOST_READS <= math.ceil(iters / krylov.CHUNK) + 1
    orig = krylov.run_chunks
    monkeypatch.setattr(
        krylov, "run_chunks",
        lambda body, st, live, max_iters, chunk=1: orig(body, st, live,
                                                        max_iters, 1))
    krylov.reset_host_reads()
    r1 = krylov.cg_matvec(mv, b)
    assert krylov.HOST_READS == iters == int(r1.iters)
    assert torch.equal(r1.x, r16.x) and torch.equal(r1.resnorm, r16.resnorm)
