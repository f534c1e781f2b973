"""The port's ordered Schur forms (``linalg_solver_tpu_torch.ops.ordschur``)
against the JAX package, fed the same real Schur pair, computed once by
the JAX package: the two Schur solvers round apart, and a reorder of two
different forms is not comparable entry by entry.

Values (rsf2csf, the sorted and reordered forms, the cluster condition
numbers' ``gap`` and ``p_fro``): within 1e-5 of the largest entry; ``m``
and ``perturbed`` exact.  ``s`` and ``sep``, with the JAX package's random
start handed to the port: within 1e-4 relative.  Invariant subspaces by
their projectors, with eigenvalues matched one to one.  The spectra are
spread (every distinct modulus and real part at least 0.05 apart), so that
no near-tie of the sort keys can order the two packages apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from linalg_solver_tpu.ops import ordschur as jord
from linalg_solver_tpu.ops.schur import real_schur_vectors as jschur
from linalg_solver_tpu_torch.ops import ordschur as tord
from linalg_solver_tpu_torch.ops.schur import SchurVectors

B, N = 3, 12
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _same_fields(rt, rj, tol=TOL, exact=("m",)):
    assert rt._fields == rj._fields
    for f in rj._fields:
        if f in exact:
            np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                          np.asarray(getattr(rj, f)))
        else:
            _close(getattr(rt, f), getattr(rj, f), tol)


def spread_batch(bsz, n, seed, pairs=3):
    """Real matrices with ``pairs`` complex pairs and real eigenvalues
    otherwise, every distinct |λ| and Re λ at least 0.05 apart (redrawn
    from the seed until they are), under a well-conditioned similarity."""
    rng = np.random.RandomState(seed)
    out = np.empty((bsz, n, n), np.float32)
    for b in range(bsz):
        while True:
            mods = rng.uniform(0.3, 3.0, n - pairs)
            ang = rng.uniform(0.4, 1.2, pairs) * rng.choice([-1, 1], pairs)
            re = np.r_[mods[:pairs] * np.cos(ang),
                       mods[pairs:] * rng.choice([-1, 1], n - 2 * pairs)]
            gaps = [np.diff(np.sort(k)).min() for k in (mods, re)]
            if min(gaps) > 0.05:
                break
        D = np.zeros((n, n))
        for k in range(pairs):
            c, s = mods[k] * np.cos(ang[k]), mods[k] * np.sin(ang[k])
            D[2 * k:2 * k + 2, 2 * k:2 * k + 2] = [[c, s], [-s, c]]
        D[2 * pairs:, 2 * pairs:] = np.diag(re[pairs:])
        P = np.eye(n) + 0.3 * rng.randn(n, n) / np.sqrt(n)
        out[b] = np.linalg.solve(P, D @ P)
    return out


@pytest.fixture(scope="module")
def pair():
    """(A, the JAX package's real Schur pair as numpy, the same as torch)."""
    A = spread_batch(B, N, seed=0)
    sv = jschur(jnp.asarray(A))
    assert bool(np.asarray(sv.converged).all())
    T, Q = np.array(sv.T), np.array(sv.Q)
    return A, sv, T, Q


def test_rsf2csf_matches_jax(pair):
    _, _, T, Q = pair
    rj = jord.rsf2csf_batched(jnp.asarray(T), jnp.asarray(Q))
    rt = tord.rsf2csf_batched(_t(T), _t(Q))
    _same_fields(rt, rj)
    assert float(rt.t_re.tril(-1).abs().max()) == 0.0
    assert float(rt.t_im.tril(-1).abs().max()) == 0.0


def test_rsf2csf_float64_reconstructs():
    """float64 end to end: Q T Qᴴ is the input, Q unitary."""
    rng = np.random.RandomState(3)
    T = np.triu(rng.randn(2, 7, 7))
    T[:, 3, 2] = -0.8          # a complex pair block at (2, 3)
    T[:, 2, 3] = 1.1
    T[:, 2, 2] = T[:, 3, 3] = 0.4
    Q = np.linalg.qr(rng.randn(2, 7, 7))[0]
    r = tord.rsf2csf_batched(_t(T), _t(Q))
    assert r.t_re.dtype == torch.float64
    Tc = (r.t_re + 1j * r.t_im).numpy()
    Qc = (r.q_re + 1j * r.q_im).numpy()
    A = Q @ T @ Q.transpose(0, 2, 1)
    for b in range(2):
        assert np.abs(Qc[b] @ Tc[b] @ Qc[b].conj().T - A[b]).max() < 1e-12
        assert np.abs(Qc[b].conj().T @ Qc[b] - np.eye(7)).max() < 1e-13
        assert abs(Tc[b, 2, 2] - (0.4 + 1j * np.sqrt(0.88))) < 1e-13


@pytest.mark.parametrize("key", ["abs_desc", "abs_asc", "real_desc",
                                 "real_asc"])
def test_sort_matches_jax(pair, key):
    _, _, T, Q = pair
    rj = jord.schur_sort_batched(jnp.asarray(T), jnp.asarray(Q), key=key)
    rt = tord.schur_sort_batched(_t(T), _t(Q), key=key)
    _same_fields(rt, rj)


def test_sort_rejects_an_unknown_key(pair):
    _, _, T, Q = pair
    with pytest.raises(ValueError):
        tord.schur_sort_batched(_t(T), _t(Q), key="imag_desc")


def _selection(T, Q):
    cs = jord.rsf2csf_batched(jnp.asarray(T), jnp.asarray(Q))
    return np.diagonal(np.asarray(cs.t_re), axis1=1, axis2=2) < 0


def test_reorder_matches_jax(pair):
    _, _, T, Q = pair
    sel = _selection(T, Q)
    rj = jord.schur_reorder_batched(jnp.asarray(T), jnp.asarray(Q),
                                    jnp.asarray(sel))
    rt = tord.schur_reorder_batched(_t(T), _t(Q), _t(sel))
    _same_fields(rt, rj)
    for b in range(B):
        m = int(rt.m[b])
        assert (rt.w_re[b, :m] < 0).all() and (rt.w_re[b, m:] >= 0).all()


def test_reorder_sweeps_bound_matches_jax(pair):
    """A cut sweep count stops both sorts at the same partial order."""
    _, _, T, Q = pair
    sel = _selection(T, Q)
    rj = jord.schur_reorder_batched(jnp.asarray(T), jnp.asarray(Q),
                                    jnp.asarray(sel), sweeps=3)
    rt = tord.schur_reorder_batched(_t(T), _t(Q), _t(sel), sweeps=3)
    _same_fields(rt, rj)


def test_reorder_pulls_the_whole_conjugate_pair(pair):
    _, _, T, Q = pair
    sub = np.diagonal(T, -1, axis1=1, axis2=2)
    sel = np.zeros((B, N), bool)
    for b in range(B):
        sel[b, int(np.flatnonzero(sub[b] != 0)[0])] = True
    rj = jord.schur_reorder_batched(jnp.asarray(T), jnp.asarray(Q),
                                    jnp.asarray(sel))
    rt = tord.schur_reorder_batched(_t(T), _t(Q), _t(sel))
    _same_fields(rt, rj)
    assert (rt.m == 2).all()
    w = (rt.w_re + 1j * rt.w_im).numpy()
    assert np.abs(w[:, 1] - w[:, 0].conj()).max() < 1e-6


def _projector(v, m):
    V = v.double().numpy() if isinstance(v, torch.Tensor) else np.asarray(
        v, np.float64)
    return [V[b][:, :k] @ V[b][:, :k].T for b, k in enumerate(m)]


def _match_eigs(got, want, tol):
    for g, w in zip(got, want):
        i, j = linear_sum_assignment(np.abs(w[:, None] - g[None, :]))
        assert np.abs(w[i] - g[j]).max() <= tol * np.abs(w).max()


def test_invariant_subspace_from_the_same_schur_form(pair):
    A, sv, T, Q = pair
    sel = lambda re, im: re < 0
    rj = jord._invariant_subspace_from_schur(jnp.asarray(A), sv, sel, 1e-3)
    svt = SchurVectors(_t(T), _t(Q), _t(sv.scale), _t(sv.converged),
                       _t(sv.sweeps), _t(sv.clean))
    rt = tord._invariant_subspace_from_schur(_t(A), svt, sel, 1e-3)
    assert rt._fields == rj._fields
    m = np.asarray(rj.m)
    np.testing.assert_array_equal(rt.m.numpy(), m)
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    for pt, pj in zip(_projector(rt.v, m), _projector(rj.v, m)):
        assert np.abs(pt - pj).max() <= TOL
    _close(rt.w_re, rj.w_re)
    _close(rt.w_im, rj.w_im)
    assert float(rt.resid.max()) < 1e-5
    for b, k in enumerate(m):
        assert float(rt.v[b, :, k:].abs().max()) == 0.0


@pytest.mark.parametrize("which", ["stable", "outside_radius_1"])
def test_invariant_subspace_matches_jax(pair, which):
    """Each package's own Schur form: projectors and spectra."""
    A = pair[0]
    sel = ((lambda re, im: re < 0) if which == "stable"
           else (lambda re, im: re * re + im * im > 1.0))
    rj = jord.invariant_subspace_batched(jnp.asarray(A), sel)
    rt = tord.invariant_subspace_batched(_t(A), sel)
    m = np.asarray(rj.m)
    np.testing.assert_array_equal(rt.m.numpy(), m)
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    assert bool(rt.ok.all())
    for pt, pj in zip(_projector(rt.v, m), _projector(rj.v, m)):
        assert np.abs(pt - pj).max() <= 1e-4
    wt = rt.w_re.double().numpy() + 1j * rt.w_im.double().numpy()
    wj = np.asarray(rj.w_re, np.float64) + 1j * np.asarray(rj.w_im)
    _match_eigs([w[:k] for w, k in zip(wt, m)],
                [w[:k] for w, k in zip(wj, m)], 1e-4)


def test_invariant_subspace_empty_and_full():
    A = np.random.RandomState(11).randn(2, 6, 6).astype(np.float32)
    full = tord.invariant_subspace_batched(
        _t(A), lambda re, im: torch.ones_like(re, dtype=torch.bool))
    assert (full.m == 6).all() and bool(full.ok.all())
    empty = tord.invariant_subspace_batched(
        _t(A), lambda re, im: torch.zeros_like(re, dtype=torch.bool))
    assert (empty.m == 0).all() and float(empty.v.abs().max()) == 0.0


def _jax_start(bsz, n):
    key = jax.random.PRNGKey(0)
    return (np.array(jax.random.normal(key, (bsz, n, n), jnp.float32)),
            np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                       (bsz, n, n), jnp.float32)))


def _cluster_cases(pair):
    """The spread batch with Re λ < 0 selected, and a triangular lane
    whose repeated eigenvalue 2 is split across the clusters (perturbed),
    padded to N with eigenvalues 7 … (unselected)."""
    _, _, T, Q = pair
    sel = _selection(T, Q)
    T2 = np.triu(np.random.RandomState(9).randn(N, N)).astype(np.float32)
    np.fill_diagonal(T2, [2.0, 2.0, 3.0, 4.0, 5.0, 6.0]
                     + list(range(7, 7 + N - 6)))
    s2 = np.zeros(N, bool)
    s2[0] = True
    return (np.concatenate([T, T2[None]]),
            np.concatenate([Q, np.eye(N, dtype=np.float32)[None]]),
            np.concatenate([sel, s2[None]]))


@pytest.mark.parametrize("sep_iters", [0, 5])
def test_cluster_cond_matches_jax(pair, sep_iters):
    T, Q, sel = _cluster_cases(pair)
    u0 = _jax_start(B + 1, N)
    rj = jord.schur_cluster_cond_batched(jnp.asarray(T), jnp.asarray(Q),
                                         jnp.asarray(sel),
                                         sep_iters=sep_iters)
    rt = tord.schur_cluster_cond_batched(_t(T), _t(Q), _t(sel),
                                         sep_iters=sep_iters, u0=u0)
    assert rt._fields == rj._fields
    for f in ("m", "perturbed"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    assert rt.perturbed.tolist() == [False] * B + [True]
    for f in ("gap", "p_fro"):
        _close(getattr(rt, f), getattr(rj, f))
    good = slice(0, B)       # the perturbed lane's s and sep are roundoff
    for f in ("s", "sep"):
        want = np.asarray(getattr(rj, f), np.float64)[good]
        got = getattr(rt, f).double().numpy()[good]
        assert (np.abs(got - want) <= 1e-4 * want).all(), (f, got, want)
    if sep_iters:
        assert float(rt.sep[-1]) < 1e-2


def test_cluster_cond_empty_and_full(pair):
    _, _, T, Q = pair
    for sel in (np.zeros((B, N), bool), np.ones((B, N), bool)):
        cc = tord.schur_cluster_cond_batched(_t(T), _t(Q), _t(sel))
        assert (cc.s == 1.0).all() and torch.isinf(cc.sep).all()
        assert torch.isinf(cc.gap).all() and not bool(cc.perturbed.any())


def test_cluster_cond_generator_start(pair):
    """Without a start the iteration draws one on a generator: the same
    seed gives the same sep, and sep bounds the gap from below."""
    T, Q, sel = _cluster_cases(pair)
    runs = [tord.schur_cluster_cond_batched(
        _t(T), _t(Q), _t(sel), generator=torch.Generator().manual_seed(3))
        for _ in range(2)]
    assert torch.equal(runs[0].sep, runs[1].sep)
    default = tord.schur_cluster_cond_batched(_t(T), _t(Q), _t(sel))
    assert bool((default.sep[:B] <= default.gap[:B] + 1e-5).all())
