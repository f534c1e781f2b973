"""The port's real Schur solver (``linalg_solver_tpu_torch.ops.schur``)
against the JAX package's ``ops.schur``, both on the CPU, fed the same
seeded numpy inputs, stage by stage (the whole solver:
``tests/test_torch_schur_solver.py``).

On identical input state, at most ``1e-5·max(1, ‖A‖∞)`` apart (``‖A‖∞``
of the stage's input): balancing, Hessenberg with and without Q, one
``_deflate`` (plain and strict), ``_eigvals_from_T``,
``_standardize_real_blocks`` and ``_trevc_full``; the integer state
(``hi``, ``stagnant``, flags) equal.  The sweeps, the AED round, the
subnormal reflector and the masked sweeps are in
``tests/test_torch_schur_sweeps.py`` (files of at most 11 tests:
pytest-xdist's ``--dist loadfile`` queues a file by its number of tests,
and so queues these after the slow JAX file ``tests/test_lu_large.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import schur as js
from linalg_solver_tpu_torch.ops import schur as ts
from torch_schur_cases import _close, _exact, _kinds, _np, _t

# --- stages ---------------------------------------------------------------

def test_balance_matches_jax():
    rng = np.random.RandomState(0)
    d = 2.0 ** rng.randint(-8, 9, (3, 12))
    a = (rng.randn(3, 12, 12) * d[:, :, None] / d[:, None, :]).astype(
        np.float32)
    Aj, fj = js._balance_impl(jnp.asarray(a))
    At, ft = ts._balance_impl(torch.from_numpy(a))
    _exact(ft, fj)
    _close(At, Aj, np.abs(a).sum(2).max())
    _close(ts.balance_batched(torch.from_numpy(a)), Aj, np.abs(a).sum(2).max())
    assert np.abs(_np(At)).sum(2).max() < np.abs(a).sum(2).max()


@pytest.mark.parametrize("with_q", [False, True])
def test_hessenberg_matches_jax(with_q):
    a = np.random.RandomState(1).randn(3, 12, 12).astype(np.float32)
    Hj, Qj = js._hessenberg_impl(jnp.asarray(a), with_q=with_q)
    Ht, Qt = ts._hessenberg_impl(torch.from_numpy(a), with_q=with_q)
    scale = np.abs(a).sum(2).max()
    _close(Ht, Hj, scale)
    if with_q:
        _close(Qt, Qj, 1.0)
    else:
        _close(ts.hessenberg(torch.from_numpy(a)), js.hessenberg(a), scale)
    assert np.abs(np.tril(_np(Ht), -2)).max() < 1e-5 * scale


def _deflate_input():
    """A padded Hessenberg state with subdiagonals on every criterion's
    side: exact and tiny zeros, roundoff-scale entries, a trailing 2×2,
    and lanes past the stall breaker's 20 stagnant sweeps."""
    n = 12
    rng = np.random.RandomState(2)
    H = np.triu(rng.randn(4, n + 1, n + 1), -1)
    H[:, n, :] = 0.0
    H[:, :, n] = 0.0
    H[:, n, n - 1] = 0.0
    H[0, 6, 5] = 1e-30                       # below tiny/eps
    H[0, 11, 10] = 0.0                       # trailing 1×1
    H[1, 11, 10] = 3e-8                      # at the eps·‖A‖ floor
    H[1, 10, 9] = 0.0                        # then a trailing 2×2
    H[2, 4, 3] = 5e-5                        # stall-breaker territory
    H[2, 3, 4] = 1e-4
    H[2, 4, 4] = H[2, 3, 3] + 1e-3
    H[3, 8, 7] = 5e-7
    H[3, 7, 8] = 1e-9                        # Ahues–Tisseur product
    H = H.astype(np.float32)
    hi = np.array([n - 1] * 4, np.int32)
    stag = np.array([0, 3, 60, 25], np.int32)
    anorm = np.abs(H).sum(2).max(1).astype(np.float32)
    return H, hi, stag, anorm


@pytest.mark.parametrize("strict", [False, True])
def test_deflate_matches_jax(strict):
    H, hi, stag, anorm = _deflate_input()
    rj = js._deflate(jnp.asarray(H), jnp.asarray(hi), jnp.asarray(stag),
                     jnp.asarray(anorm), strict=strict)
    rt = ts._deflate(_t(H), _t(hi), _t(stag), _t(anorm), strict=strict)
    for got, want in zip(rt, rj):
        _exact(got, want)
    # every lane zeroed something (lane 2 only by the stall breaker,
    # which the strict criteria leave out), and the breaker flagged the
    # lane it force-split
    changed = (_np(rt[0]) != H).any(axis=(1, 2)).tolist()
    assert changed == [True, True, not strict, True]
    assert _np(rt[3]).tolist() == ([False, False, True, False]
                                   if not strict else [False] * 4)


def _schur_tq(a):
    """JAX's converged ``(T, Q)`` before standardization, as numpy."""
    res, _, Q, _ = js._run_schur(jnp.asarray(a), 0, 64, True, True)
    return np.asarray(res.T), np.asarray(Q)


def test_eigvals_standardize_and_trevc_match_jax():
    a = _kinds(10, 5)
    T, Q = _schur_tq(a)
    scale = np.abs(T).sum(2).max()
    for got, want in zip(ts._eigvals_from_T(_t(T)), js._eigvals_from_T(T)):
        _close(got, want, scale)
    Tj, Qj = js._standardize_real_blocks(jnp.asarray(T), jnp.asarray(Q))
    Tt, Qt = ts._standardize_real_blocks(_t(T), _t(Q))
    _close(Tt, Tj, scale)
    _close(Qt, Qj, 1.0)
    Tj = np.asarray(Tj)
    yj = js._trevc_full(jnp.asarray(Tj))
    yt = ts._trevc_full(_t(Tj))
    _close(yt[0], yj[0], 1.0)
    _close(yt[1], yj[1], 1.0)
    _exact(yt[2], yj[2])
    # real and complex-pair columns both solved
    lam_im = _np(ts._eigvals_from_T(_t(Tj))[1])
    assert _np(yt[2]).all() and (lam_im != 0).any() and (lam_im == 0).any()
    vj = js._trevc_real(jnp.asarray(Tj))
    vt = ts._trevc_real(_t(Tj))
    _close(vt[0], vj[0], 1.0)
    _exact(vt[1], vj[1])


def test_chase_wrapper_runs_its_plain_version_on_the_cpu():
    """``kernels.schur_chase.francis_chase`` on CPU tensors is its plain
    version, leaves its inputs as they were, and checks its arguments;
    on the card the kernel is held against it bitwise
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc

    a = torch.from_numpy(_kinds(24, 12))
    H, Q, hi, stag, anorm, _ = ts._schur_init(a, with_q=True)
    calls = []
    orig = sc.francis_chase

    def rec(*args):
        calls.append([x.clone() if isinstance(x, torch.Tensor) else
                      [t.clone() for t in x] if isinstance(x, list) else x
                      for x in args])
        return orig(*args)

    sc.francis_chase = rec
    try:
        ts._one_sweep(H, hi, stag, anorm, Q, npairs=3)
    finally:
        sc.francis_chase = orig
    # the window-shift solve's inner chases first, the main chase last
    Hc, Qc, tables, nc = calls[-1]
    assert nc == 2 and {c[3] for c in calls[:-1]} == {0}
    assert tables[0].shape == (4, 3, 25)
    before = Hc.clone()
    got = sc.francis_chase(Hc, Qc, tables, nc)
    want = sc.francis_chase_reference(Hc, Qc, tables, nc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(Hc, before) and not torch.equal(got[0], before)
    with pytest.raises(ValueError, match="tables"):
        sc.francis_chase(Hc, Qc, tables, nc + 1)
    with pytest.raises(ValueError, match="Q must be"):
        sc.francis_chase(Hc, Qc[:, :, :-1], tables, nc)
