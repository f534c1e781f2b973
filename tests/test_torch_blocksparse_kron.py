"""The port's block-sparse operators and Kronecker family
(``linalg_solver_tpu_torch.ops.blocksparse`` / ``ops.kron``) against the
JAX package's on the same numpy inputs.

The block matvec agrees to 1e-6 of its largest entry (the port sums a
row's blocks in a fixed order, the JAX package by one-hot GEMMs) and is
bitwise the same from call to call; the block-sparse solves agree to
1e-4 with equal ``converged`` and ``iters``; the eigenpairs (the JAX
package's draws injected) to 1e-4 of the largest.  The Kronecker solves
agree to 1e-4 of each lane's largest entry and with the dense float64
solve of the materialized operator, ``ok`` exactly (a lane with
λ(A) + μ(B) = 0 flagged on both)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import blocksparse as jbs
from linalg_solver_tpu.ops import kron as jkr
from linalg_solver_tpu_torch.ops import blocksparse, kron

from test_torch_arnoldi import _jax_splice


def _block_tridiag(nb, bs, seed, dominance=4.0):
    rng = np.random.RandomState(seed)
    n = nb * bs
    A = np.zeros((n, n), np.float32)
    for i in range(nb):
        for j in range(nb):
            if abs(i - j) <= 1:
                A[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = \
                    rng.randn(bs, bs) * 0.3
    return A + dominance * np.eye(n, dtype=np.float32)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i in range(got.shape[0]):
        assert np.abs(got[i] - want[i]).max() <= rtol * np.abs(want[i]).max()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_blocksparse_operator_matches_jax():
    """Round trip, matvec and Jacobi against the JAX package; duplicate
    coordinates sum; the matvec is bitwise repeatable."""
    nb, bs = 6, 8
    A = _block_tridiag(nb, bs, seed=1)
    op = blocksparse.blocksparse_from_dense(A, bs)
    opj = jbs.blocksparse_from_dense(A, bs)
    assert op.rows.tolist() == np.asarray(opj.rows).tolist()
    assert op.cols.tolist() == np.asarray(opj.cols).tolist()
    assert torch.equal(blocksparse.blocksparse_to_dense(op), _t(A))
    v = np.random.RandomState(2).randn(3, nb * bs).astype(np.float32)
    mv = blocksparse.make_blocksparse_matvec(op)
    y = mv(_t(v))
    _close(y, jbs.make_blocksparse_matvec(opj)(jnp.asarray(v)), 1e-6)
    assert torch.equal(y, mv(_t(v)))
    _close(blocksparse._jacobi_from_blocks(op)(_t(v)),
           jbs._jacobi_from_blocks(opj)(jnp.asarray(v)), 1e-6)
    dup = blocksparse.BlockSparse(torch.cat([op.blocks, op.blocks[:1]]),
                                  torch.cat([op.rows, op.rows[:1]]),
                                  torch.cat([op.cols, op.cols[:1]]), nb)
    A2 = A.copy()
    A2[:bs, :bs] *= 2
    assert torch.allclose(blocksparse.blocksparse_to_dense(dup), _t(A2))
    assert torch.allclose(blocksparse.make_blocksparse_matvec(dup)(_t(v)),
                          _t(v) @ _t(A2).T, atol=1e-5)


@pytest.mark.parametrize("method", ["gmres", "cg", "bicgstab"])
def test_blocksparse_solve_matches_jax(method):
    nb, bs = 6, 8
    A = _block_tridiag(nb, bs, seed=3)
    if method == "cg":
        A = (A @ A.T / 4.0).astype(np.float32)
    op = blocksparse.blocksparse_from_dense(A, bs)
    opj = jbs.blocksparse_from_dense(A, bs)
    b = np.random.RandomState(4).randn(2, nb * bs).astype(np.float32)
    rt = blocksparse.blocksparse_solve(op, _t(b), method=method, tol=1e-6)
    rj = jbs.blocksparse_solve(opj, jnp.asarray(b), method=method, tol=1e-6)
    assert bool(rt.converged.all())
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    assert int(rt.iters) == int(rj.iters)
    _close(rt.x, rj.x, 1e-4)
    want = np.linalg.solve(A.astype(np.float64), b.T).T
    _close(rt.x, want, 1e-4)


def test_blocksparse_eigs_matches_jax():
    nb, bs = 6, 8
    A = _block_tridiag(nb, bs, seed=8, dominance=2.0)
    A[:bs, :bs] = np.diag([20.0, 15.0, 11.0] + [2.0] * (bs - 3))
    op = blocksparse.blocksparse_from_dense(A, bs)
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, nb * bs),
                                    jnp.float32))
    rt = blocksparse.blocksparse_eigs(op, 3, which="LM", max_restarts=60,
                                      v0=_t(v0),
                                      splice=_jax_splice(1, nb * bs, 16))
    rj = jbs.blocksparse_eigs(jbs.blocksparse_from_dense(A, bs), 3,
                              which="LM", max_restarts=60)
    assert bool(rt.converged.all())
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    got = np.sort(rt.real.numpy()[0])
    assert np.abs(got - np.sort(np.asarray(rj.real)[0])).max() <= 20e-4
    w = np.linalg.eigvals(A.astype(np.float64))
    want = np.sort(w[np.argsort(-np.abs(w))][:3].real)
    assert np.abs(got - want).max() <= 2e-3 * 20


def _nonnormal_operator(n=2048, bs=64, pairs=10, seed=68):
    """Diagonal blocks and ``pairs`` pairs (i, j), (j, i) of blocks off
    it (5 % of the blocks at the defaults), every block drawn on its own
    (non-normal), + 8 I, with 20, 15, 11 added on the first block's
    diagonal: eigenvalues ≈ 28.1, 23.9, 19.6 over a bulk within 12.2."""
    rng = np.random.RandomState(seed)
    nbk = n // bs
    A = np.zeros((n, n), np.float32)
    offs = set()
    while len(offs) < pairs:
        i, j = sorted(int(v) for v in rng.randint(nbk, size=2))
        if i != j:
            offs.add((i, j))
    for i in range(nbk):
        A[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = rng.randn(bs, bs) * 0.3
    for i, j in sorted(offs):
        A[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.randn(bs, bs) * 0.3
        A[j * bs:(j + 1) * bs, i * bs:(i + 1) * bs] = rng.randn(bs, bs) * 0.3
    A += 8.0 * np.eye(n, dtype=np.float32)
    A[:bs, :bs] += np.diag([20.0, 15.0, 11.0] + [0.0] * (bs - 3)
                           ).astype(np.float32)
    return A


def test_nonnormal_blocksparse_eigs_track_jax_across_restarts():
    """The 3 largest eigenpairs of a non-normal block-sparse operator at
    n = 2048, 64-wide blocks, 8 runs, m = 32, stopped after 1 and after 3
    restarts: the port's Ritz values agree with the JAX package's to
    1e-5 (1 restart) and 1e-4 (3 restarts) of the largest; after 1
    restart ``converged`` is equal, after 3 the largest true residuals
    are within a factor 2 of each other.  The true residual grows over
    the restarts in both packages while the estimate β·|yₘ| that stops
    them falls: the printed counts and residuals show it."""
    A = _nonnormal_operator()
    n, B = A.shape[0], 8
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (B, n),
                                    jnp.float32))
    op, jop = blocksparse.blocksparse_from_dense(A, 64), \
        jbs.blocksparse_from_dense(A, 64)
    for restarts, tol in ((1, 1e-5), (3, 1e-4)):
        rt = blocksparse.blocksparse_eigs(op, 3, batch=B, m=32,
                                          max_restarts=restarts, v0=_t(v0))
        rj = jbs.blocksparse_eigs(jop, 3, batch=B, m=32,
                                  max_restarts=restarts)
        got = np.sort(rt.real.numpy(), axis=1)
        ref = np.sort(np.asarray(rj.real), axis=1)
        ct, cj = int(rt.converged.sum()), int(np.asarray(rj.converged).sum())
        print(f"non-normal, {restarts} restart(s): converged port {ct}, JAX "
              f"{cj} of {B * 3}; true residual max port "
              f"{float(rt.resid.max()):.3e}, JAX "
              f"{float(np.asarray(rj.resid).max()):.3e}; Ritz values "
              f"{np.abs(got - ref).max():.3e} apart")
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
        if restarts == 1:
            assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
        else:
            ratio = float(rt.resid.max()) / float(np.asarray(rj.resid).max())
            assert 0.5 <= ratio <= 2.0


def test_kron_products_and_solves_match_jax():
    rng = np.random.RandomState(5)
    a = (rng.randn(2, 6, 6) + 6 * np.eye(6)).astype(np.float32)
    b = (rng.randn(2, 5, 5) + 5 * np.eye(5)).astype(np.float32)
    x = rng.randn(2, 30).astype(np.float32)
    xk = rng.randn(2, 30, 3).astype(np.float32)
    K = kron.kron_batched(_t(a), _t(b))
    _close(K, jkr.kron_batched(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    for v in (x, xk):
        _close(kron.kron_matvec_batched(_t(a), _t(b), _t(v)),
               jkr.kron_matvec_batched(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(v)), 1e-5)
        got = kron.kron_solve_batched(_t(a), _t(b), _t(v))
        _close(got, jkr.kron_solve_batched(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(v)), 1e-4)
        want = np.linalg.solve(K.double().numpy(),
                               v.reshape(2, 30, -1).astype(np.float64))
        _close(got.reshape(want.shape), want, 1e-4)
    al = (rng.randn(2, 7, 4) + 2 * np.eye(7, 4)).astype(np.float32)
    bl = (rng.randn(2, 6, 3) + 2 * np.eye(6, 3)).astype(np.float32)
    c = rng.randn(2, 42).astype(np.float32)
    xt, ok = kron.kron_lstsq_batched(_t(al), _t(bl), _t(c))
    xj, okj = jkr.kron_lstsq_batched(jnp.asarray(al), jnp.asarray(bl),
                                     jnp.asarray(c))
    assert ok.tolist() == np.asarray(okj).tolist() == [True, True]
    _close(xt, xj, 1e-4)


def test_kronsum_matches_jax_and_flags_a_singular_pencil():
    """(A ⊕ B) x = c at m = 6, n = 5; lane 1 has λ(A) + μ(B) = 0."""
    rng = np.random.RandomState(6)
    a = (rng.randn(2, 6, 6) + 6 * np.eye(6)).astype(np.float32)
    b = (rng.randn(2, 5, 5) + 5 * np.eye(5)).astype(np.float32)
    a[1] = np.diag([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    b[1] = np.diag([-1.0, 7.0, 8.0, 9.0, 10.0])
    c = rng.randn(2, 30).astype(np.float32)
    rt = kron.kronsum_solve_batched(_t(a), _t(b), _t(c))
    rj = jkr.kronsum_solve_batched(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c))
    assert rt.ok.tolist() == np.asarray(rj.ok).tolist() == [True, False]
    _close(rt.x[:1], np.asarray(rj.x)[:1], 1e-4)
    K = np.kron(a[0].astype(np.float64), np.eye(5)) + np.kron(
        np.eye(6), b[0].astype(np.float64))
    want = np.linalg.solve(K, c[0])
    assert np.abs(rt.x[0].numpy() - want).max() <= 1e-3 * np.abs(want).max()
    with pytest.raises(ValueError, match="one right-hand side"):
        kron.kronsum_solve_batched(_t(a), _t(b), _t(c[:, :, None].repeat(
            2, axis=2)))
