"""The port's whole real Schur solver (``linalg_solver_tpu_torch.ops
.schur``) against the JAX package's ``ops.schur``, both on the CPU, fed
the same seeded numpy inputs (the stages: ``tests/test_torch_schur.py``).

The whole solver cannot be bitwise the reference's (Francis iteration's
path follows its roundings): ``converged`` and ``clean`` equal JAX's,
the eigenvalues, matched to numpy's float64 ones, no farther from them
than JAX's are plus ``1e-5·‖A‖∞``, ``Q`` orthogonal and ``Q T Qᵀ`` the
balanced matrix to ``1e-5·‖A‖∞``.  Each size's batch holds one lane of
each input kind: Gaussian, skew-symmetric (all complex pairs), a
defective Jordan similarity and a companion matrix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import schur as js
from linalg_solver_tpu_torch.ops import schur as ts
from torch_schur_cases import TOL, _close, _exact, _kinds, _match_dev, _np


SIZES = [(2, {}), (3, {}), (8, {}), (24, {}),
         (32, dict(nshift_pairs=2, aed_w=8))]


@pytest.mark.parametrize("n,kw", SIZES, ids=[str(n) for n, _ in SIZES])
def test_whole_solver_matches_jax(n, kw):
    a = _kinds(n, 10 + n)
    norm = np.abs(a).sum(2).max(1)
    want = np.linalg.eigvals(a.astype(np.float64))

    ej = js.eigvals_schur(jnp.asarray(a), **kw)
    et = ts.eigvals_schur(torch.from_numpy(a), **kw)
    _exact(et.converged, ej.converged)
    _exact(et.clean, ej.clean)
    assert _np(et.converged).all()
    dj = _match_dev(np.asarray(ej.real) + 1j * np.asarray(ej.imag), want)
    dt = _match_dev(_np(et.real) + 1j * _np(et.imag), want)
    assert (dt <= dj + TOL * norm).all(), (dt, dj)
    # the defective eigenvalue's members: within its eps^(1/3) scatter
    if n >= 3:
        lam = _np(et.real)[2] + 1j * _np(et.imag)[2]
        assert np.sort(np.abs(lam - 2.0))[:3].max() <= 1e-2 * norm[2]

    rj = js.real_schur(jnp.asarray(a), **kw)
    rt = ts.real_schur(torch.from_numpy(a), **kw)
    _exact(rt.converged, rj.converged)
    _exact(rt.clean, rj.clean)
    T = _np(rt.T)
    assert np.abs(np.tril(T, -2)).max() == 0.0
    sub = np.abs(np.diagonal(T, -1, 1, 2)) > 0
    assert not (sub[:, :-1] & sub[:, 1:]).any()
    assert rt.sweeps.dtype == torch.int32 and int(rt.sweeps) >= 0

    vj = js.real_schur_vectors(jnp.asarray(a), **kw)
    vt = ts.real_schur_vectors(torch.from_numpy(a), **kw)
    _exact(vt.converged, vj.converged)
    _exact(vt.clean, vj.clean)
    Q = _np(vt.Q).astype(np.float64)
    assert np.abs(Q.transpose(0, 2, 1) @ Q - np.eye(n)).max() <= 1e-5 * n
    bal = _np(ts.balance_batched(torch.from_numpy(a))) if n > 2 else a
    recon = Q @ _np(vt.T) @ Q.transpose(0, 2, 1)
    assert (np.abs(recon - bal).max((1, 2)) <= TOL * np.maximum(norm, 1)
            * 10).all()
    _close(vt.scale, vj.scale, 1.0)

    gj = js.eig_real_batched(jnp.asarray(a), **kw)
    gt = ts.eig_real_batched(torch.from_numpy(a), **kw)
    _exact(gt.converged, gj.converged)
    _exact(gt.clean, gj.clean)
    _exact(gt.valid.sum(1), np.asarray(gj.valid).sum(1))
    # a valid column is an eigenvector of A for its eigenvalue
    V = _np(gt.vectors).astype(np.float64)
    lam = _np(gt.real).astype(np.float64)
    res = np.abs(a @ V - V * lam[:, None, :]).max(1)
    ok = _np(gt.valid)
    assert (res[ok] <= 1e-3 * np.repeat(norm, ok.sum(1))).all()


def test_float64_end_to_end():
    """float64 runs end to end (the reference refuses it on the TPU
    only): at n = 24 the eigenvalues land within 1e-9·‖A‖ of numpy's."""
    a = _kinds(24, 7)[:2].astype(np.float64)
    norm = np.abs(a).sum(2).max(1)
    with jax.enable_x64(True):
        ej = js.eigvals_schur(jnp.asarray(a))
        et = ts.eigvals_schur(torch.from_numpy(a))
        assert et.real.dtype == torch.float64
        _exact(et.converged, ej.converged)
        _exact(et.clean, ej.clean)
        want = np.linalg.eigvals(a)
        dj = _match_dev(np.asarray(ej.real) + 1j * np.asarray(ej.imag), want,
                        defective=None)
        dt = _match_dev(_np(et.real) + 1j * _np(et.imag), want,
                        defective=None)
    assert (dt <= 1e-9 * norm).all() and (dt <= dj + 1e-12 * norm).all()
    vt = ts.real_schur_vectors(torch.from_numpy(a))
    Q = vt.Q.numpy()
    assert np.abs(Q.transpose(0, 2, 1) @ Q - np.eye(24)).max() < 1e-12
