"""The port's Schur sweeps against the JAX package's ``ops.schur``, both on
the CPU, on the same seeded state: one ``_one_sweep`` with and without Q
at one and two shift pairs, one AED round at n = 32, w = 8, a subnormal
reflector, and the masked sweeps on a deflated state.  Split from
``tests/test_torch_schur.py`` (the other stages), at the same tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import schur as js
from linalg_solver_tpu_torch.ops import schur as ts
from torch_schur_cases import (_close, _exact, _kinds, _np, _state,
                               _swept_state, _t)


@pytest.mark.parametrize("with_q", [False, True])
@pytest.mark.parametrize("npairs", [1, 2])
def test_one_sweep_matches_jax(npairs, with_q):
    a = np.random.RandomState(3).randn(3, 16, 16).astype(np.float32)
    H, Q, hi, stag, anorm = _state(a, with_q)
    rj = js._one_sweep(jnp.asarray(H), jnp.asarray(hi), jnp.asarray(stag),
                       jnp.asarray(anorm),
                       jnp.asarray(Q) if with_q else None, npairs=npairs)
    rt = ts._one_sweep(_t(H), _t(hi), _t(stag), _t(anorm), _t(Q),
                       npairs=npairs)
    scale = anorm.max()
    _close(rt[0], rj[0], scale)
    _exact(rt[1], rj[1])
    _exact(rt[2], rj[2])
    _exact(rt[4], rj[4])
    if with_q:
        _close(rt[3], rj[3], 1.0)
    # the sweep moved the matrix
    assert np.abs(_np(rt[0]) - H).max() > 1e-2


def test_aed_round_matches_jax():
    """One AED round at n = 32, w = 8, two shift pairs, on a state three
    sweeps in, where every window deflates something and the Jordan lane
    nibbles its whole window.  That lane's window holds a defective
    eigenvalue, whose Schur basis roundoff does not determine (the two
    libraries' bases differ by O(‖A‖) there): it is held by its flags
    and its spectrum; the others entry by entry."""
    a = _kinds(32, 4)
    H, Q, hi, stag, anorm, _ = _swept_state(a, 3, 2, 8)
    rj = js._aed(jnp.asarray(H), jnp.asarray(Q), jnp.asarray(hi),
                 jnp.asarray(stag), jnp.asarray(anorm), 8, 2, True)
    rt = ts._aed(_t(H), _t(Q), _t(hi), _t(stag), _t(anorm), 8, 2, True)
    for i in (2, 3, 5):
        _exact(rt[i], rj[i])
    _exact(rt[4][2], rj[4][2])
    assert (_np(rt[2]) < hi).any() and _np(rt[5]).tolist()[2]
    ok = [0, 1, 3]
    scale = anorm[ok].max()
    _close(_np(rt[0])[ok], np.asarray(rj[0])[ok], scale)
    _close(_np(rt[1])[ok], np.asarray(rj[1])[ok], 1.0)
    _close(_np(rt[4][0])[ok], np.asarray(rj[4][0])[ok], scale)
    _close(_np(rt[4][1])[ok], np.asarray(rj[4][1])[ok], scale)
    ev = [np.sort_complex(np.linalg.eigvals(np.asarray(x)[2, :32, :32]
                                            .astype(np.float64)))
          for x in (rt[0], rj[0])]
    assert np.abs(ev[0] - ev[1]).max() <= 1e-2


def test_subnormal_reflector_counts_as_zero():
    """A column whose squared norm is subnormal: the reference's
    arithmetic flushes it to zero (no reflection), where ``2/|v|²``
    would overflow and turn the result into NaN — in the Hessenberg
    steps, the chase's reflectors and AED's collapse alike."""
    v = torch.tensor([3e-23, 4e-23, 0.0], dtype=torch.float32)
    assert float(ts._reflector_scale((v * v).sum()[None])[0]) == 0.0
    a = np.zeros((1, 4, 4), np.float32)
    a[0] = np.diag([1.0, 2.0, 3.0, 4.0])
    a[0, 2, 0], a[0, 3, 0] = 3e-23, 4e-23
    Hj, Qj = js._hessenberg_impl(jnp.asarray(a), with_q=True)
    Ht, Qt = ts._hessenberg_impl(torch.from_numpy(a), with_q=True)
    assert torch.isfinite(Ht).all() and torch.isfinite(Qt).all()
    _close(Ht, Hj, 4.0)
    _close(Qt, Qj, 1.0)
    # the chase: a state whose first bulge has a subnormal 3-vector
    H = np.zeros((1, 5, 5), np.float32)
    H[0, :4, :4] = np.diag([1e-20, 1e-20, 1e-20, 1e-20])
    H[0, 1, 0] = H[0, 2, 1] = H[0, 3, 2] = 1e-20
    hi = np.array([3], np.int32)
    stag = np.array([1], np.int32)
    anorm = np.array([1.0], np.float32)
    rt = ts._one_sweep(_t(H), _t(hi), _t(stag), _t(anorm), _t(np.eye(
        4, 5, dtype=np.float32)[None]))
    rj = js._one_sweep(jnp.asarray(H), jnp.asarray(hi), jnp.asarray(stag),
                       jnp.asarray(anorm), jnp.eye(4, 5)[None])
    assert torch.isfinite(rt[0]).all() and torch.isfinite(rt[3]).all()
    _close(rt[0], rj[0], 1.0)
    _close(rt[3], rj[3], 1.0)
    # a matrix at 1e-30 (its products subnormal): finite, with the
    # reference's flags (which do not converge at this scale either)
    a = _kinds(8, 9)[:1] * 1e-30
    et = ts.eigvals_schur(torch.from_numpy(a))
    ej = js.eigvals_schur(jnp.asarray(a))
    assert torch.isfinite(et.real).all() and torch.isfinite(et.imag).all()
    _exact(et.converged, ej.converged)
    _exact(et.clean, ej.clean)


def test_masked_sweeps_leave_a_deflated_state_unchanged():
    """The early stops the reference takes on the device (every lane
    deflated) are masked passes here: an extra outer sweep on a fully
    deflated state, and an extra inner AED sweep on a deflated window,
    leave H, Q, ``hi`` and ``stagnant`` bitwise as they were and count
    no sweep."""
    a = torch.from_numpy(_kinds(32, 11))
    H, Q, hi, stag, anorm, _ = ts._schur_init(a, with_q=True)
    state = (H, Q, hi, stag, anorm, torch.zeros(4, dtype=torch.bool),
             torch.zeros((), dtype=torch.long))
    state = ts._schur_sweeps(state, 64, npairs=2, aed_w=8)
    assert int(state[6]) < 64 and not bool((state[2] >= 1).any())
    extra = ts._schur_sweeps(state, 2, npairs=2, aed_w=8)
    for got, want in zip(extra, state):
        assert torch.equal(got, want)
    # the inner loop: a window that is already deflated
    Tw = ts.F.pad(torch.triu(torch.randn(4, 8, 8)), (0, 1, 0, 1))
    Qw = ts.F.pad(torch.eye(8).expand(4, 8, 8), (0, 1))
    hw = torch.full((4,), -1, dtype=torch.long)
    sw = torch.full((4,), 5, dtype=torch.long)
    live = (hw >= 1).any()
    new = ts._one_sweep(Tw, hw, sw, Tw.abs().sum(2).amax(1), Qw,
                        strict_deflate=True)
    for got, want in zip(ts._blend(live, new[:4], (Tw, hw, sw, Qw)),
                         (Tw, hw, sw, Qw)):
        assert torch.equal(got, want)
