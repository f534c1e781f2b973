"""The AED window's inner real Schur form (``kernels.schur_window``, its
plain version ``ops.schur._window_schur``) and the port's ``ops``
surface, on the CPU.

- The plain window solve against the JAX package's inner loop (its
  ``_aed``'s ``while_loop`` of strict ``_one_sweep`` calls, driven here
  until no lane has ``hw >= 1`` or ``2w`` sweeps) on the same windows at
  w = 8: ``hw`` exact, the spectra, and each side's Schur form a
  similarity of the window by an orthogonal Q.
- The kernel's control flow (each lane sweeping until its own ``hw < 1``,
  once at least where the batch was live on entry), written out here,
  bitwise the plain version's batch loop, on lanes that converge at
  different sweeps, a lane converged on entry and a NaN lane.
- ``_aed`` through the window wrapper (the inner loop and the trailing
  deflation run) bitwise what its loops gave.
- The wrapper's checks and shared-memory mirror, the chase's variant
  mirror.
- ``ops`` re-exports the reference's names, and ``ops.dispatch`` still
  reaches the modules those names shadow.
"""

import importlib

import jax.numpy as jnp
from jax import lax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from linalg_solver_tpu.ops import schur as js
from linalg_solver_tpu_torch.ops import schur as ts
from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc
from linalg_solver_tpu_torch.ops.kernels import schur_window as sw
from torch_schur_cases import TOL, _exact, _kinds, _swept_state

W = 8


def _windows(H, hi, w=W):
    """``_aed``'s windows of a state and the rest of the window kernel's
    arguments: ``(Hw, Qw, hw, anorm_w, beta, hi_w0, n)``."""
    B, npad, _ = H.shape
    n = npad - 1
    ws = (hi - (w - 1)).clamp(0, max(n - w, 0))
    Hw = F.pad(ts._window(H[:, :n, :n], ws, w), (0, 1, 0, 1))
    Qw = F.pad(torch.eye(w, dtype=H.dtype).expand(B, w, w), (0, 1))
    beta = torch.where(ws > 0, ts._take1(H, ws, ws - 1), 0.0)
    return (Hw, Qw, (hi - ws).clamp(-1, w - 1), Hw.abs().sum(2).amax(1),
            beta, hi - ws, n)


def _jax_windows():
    """The windows of ``test_aed_round_matches_jax``'s state (n = 32, three
    sweeps in, every lane live)."""
    H, _, hi, _, _, _ = _swept_state(_kinds(32, 4), 3, 2, W)
    return _windows(torch.from_numpy(H.copy()),
                    torch.from_numpy(hi.copy()).long())


def _jax_loop(Hw, Qw, hw, anorm_w):
    """The reference's inner loop, as ``linalg_solver_tpu/ops/schur.py``
    ``_aed`` runs it: a ``lax.while_loop`` of strict sweeps while some
    lane has ``hw >= 1``, at most ``2w``."""
    w = Qw.shape[1]

    def cond(st):
        return (st[4] < 2 * w) & jnp.any(st[2] >= 1)

    def body(st):
        H, Q, h, stg, it = st
        H, h, stg, Q, _ = js._one_sweep(H, h, stg, jnp.asarray(
            anorm_w.numpy()), Q, strict_deflate=True)
        return H, Q, h, stg, it + 1

    hj = jnp.asarray(hw.numpy().astype(np.int32))
    st = (jnp.asarray(Hw.numpy()), jnp.asarray(Qw.numpy()), hj,
          jnp.zeros_like(hj), jnp.zeros((), jnp.int32))
    Hj, Qj, hj, _, _ = lax.while_loop(cond, body, st)
    return np.asarray(Hj), np.asarray(Qj), np.asarray(hj)


def test_window_solve_matches_jax():
    """The converged window is a real Schur form, whose 2×2 blocks (and,
    on the normal skew lane, whose Q within each block) the math leaves
    free: the two packages' paths settle them differently (up to 0.07 of
    the Gaussian lane's entries), so the forms are held by what they
    determine: ``hw`` exact, the spectrum to ``1e-5·‖Hw‖∞`` (the
    defective lane to 1e-2, as ``test_aed_round_matches_jax``), Q
    orthogonal and ``Q T Qᵀ`` the window to ``1e-5·‖Hw‖∞``."""
    args = _jax_windows()
    Hw, Qw, hw, an = args[:4]
    assert (hw >= 1).all()
    Ht, Qt, ht, nd, p_fin = sw.window_schur(*args)
    Hj, Qj, hj = _jax_loop(Hw, Qw, hw, an)
    assert torch.equal(p_fin, args[5] - nd) and (nd > 0).any()
    _exact(ht, hj)
    assert (ht < 1).any() and (ht >= 1).any()
    H0 = Hw.numpy()[:, :W, :W].astype(np.float64)
    for lane in range(4):
        ev = [np.sort_complex(np.linalg.eigvals(
            x[lane, :W, :W].astype(np.float64))) for x in (Ht.numpy(), Hj)]
        tol = 1e-2 if lane == 2 else TOL * max(1.0, float(an[lane]))
        assert np.abs(ev[0] - ev[1]).max() <= tol, lane
    for T, Q in ((Ht.numpy(), Qt.numpy()), (Hj, Qj)):
        T = T[:, :W, :W].astype(np.float64)
        Q = Q[:, :, :W].astype(np.float64)
        assert np.abs(Q @ Q.transpose(0, 2, 1) - np.eye(W)).max() <= TOL
        back = np.abs(Q @ T @ Q.transpose(0, 2, 1) - H0).max((1, 2))
        assert (back <= TOL * np.maximum(an.numpy(), 1.0)).all()
        assert np.abs(np.tril(T, -2)).max() <= TOL * float(an.max())


def _nan_equal(x, y):
    return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def _lanewise(Hw, Qw, hw, anorm_w):
    """The kernel's control flow: every lane sweeps on its own until its
    ``hw < 1`` (at most ``2w`` sweeps), at least once where some lane was
    live on entry.  Returns the result and each lane's sweeps."""
    w = Qw.shape[1]
    live = bool((hw >= 1).any())
    out, sweeps = [], []
    for b in range(Hw.shape[0]):
        H, Q, h, a = Hw[b:b + 1], Qw[b:b + 1], hw[b:b + 1], anorm_w[b:b + 1]
        stg = torch.zeros_like(h)
        it = 0
        while live and it < 2 * w:
            H, h, stg, Q, _ = ts._one_sweep(
                H, h, stg, a, Q, strict_deflate=True,
                chase=sc.francis_chase_reference)
            it += 1
            if int(h) < 1:
                break
        out.append((H, Q, h))
        sweeps.append(it)
    return tuple(torch.cat(x) for x in zip(*out)), sweeps


def test_lanewise_stop_is_the_batch_loop():
    Hw, Qw, hw, an, beta, hi_w0, n = _jax_windows()
    # a lane converged on entry whose window still has a subdiagonal the
    # strict criteria zero (the batch loop deflates it once), and a NaN
    # lane (live for all 2w sweeps)
    Hw = torch.cat([Hw, Hw[:2]])
    Qw = torch.cat([Qw, Qw[:2]])
    an = torch.cat([an, an[:2]])
    beta = torch.cat([beta, beta[:2]])
    hi_w0 = torch.cat([hi_w0, torch.tensor([0, W - 1])])
    hw = torch.cat([hw, torch.tensor([0, W - 1])])
    Hw[4, 5, 4] = 1e-33
    Hw[5, 3, 2] = float("nan")
    batch = ts._window_schur(Hw, Qw, hw, an, beta, hi_w0, n)
    lanes, sweeps = _lanewise(Hw, Qw, hw, an)
    for got, want in zip(lanes, batch):
        assert _nan_equal(got, want)
    assert len(set(sweeps[:4])) >= 2 and min(sweeps[:4]) < 2 * W
    assert sweeps[4] == 1 and float(batch[0][4, 5, 4]) == 0.0
    assert sweeps[5] == 2 * W and int(batch[2][5]) >= 1
    # nothing happens where no lane is live
    idle = ts._window_schur(Hw[4:5], Qw[4:5], hw[4:5], an[4:5], beta[4:5],
                            hi_w0[4:5], n)
    assert torch.equal(idle[0], Hw[4:5])


def _old_window(Hw, Qw, hw, anorm_w, beta, hi_w0, n):
    """``_aed``'s inner loop and trailing deflation run as they were
    before the window kernel."""
    w = Qw.shape[1]
    stg = torch.zeros_like(hw)
    for _ in range(2 * w):
        live = (hw >= 1).any()
        new = ts._one_sweep(Hw, hw, stg, anorm_w, Qw, strict_deflate=True)
        Hw, hw, stg, Qw = ts._blend(live, new[:4], (Hw, hw, stg, Qw))
    fi = torch.finfo(Hw.dtype)
    eps = fi.eps
    smlnum = fi.tiny * (n / eps)
    Tw = Hw[:, :w, :w]
    conv_all = hw < 1
    diag_w, sub_w, sup_w = ts._tridiag_parts(Tw)
    s_spike = beta[:, None] * Qw[:, 0, :w]

    def take_w(v, i):
        return v.gather(1, i.clamp(0, w - 1)[:, None])[:, 0]

    p = hi_w0
    nd = torch.zeros_like(hw)
    stop = torch.zeros_like(hw, dtype=torch.bool)
    for _ in range(w):
        is2 = (p >= 1) & (take_w(sub_w, p - 1) != 0)
        bstart = p - is2.long()
        foo = take_w(diag_w, p).abs()
        foo = torch.where(is2, foo + torch.sqrt(take_w(sub_w, p - 1).abs())
                          * torch.sqrt(take_w(sup_w, p - 1).abs()), foo)
        sv = take_w(s_spike, p).abs()
        sv = torch.where(is2, torch.maximum(sv, take_w(s_spike, p - 1).abs()),
                         sv)
        conv_ok = conv_all | (bstart > hw)
        defl = (~stop & (p >= 0) & conv_ok
                & (sv <= (eps * foo).clamp(min=smlnum)))
        sz = torch.where(is2, 2, 1)
        nd = nd + torch.where(defl, sz, 0)
        p = p - torch.where(defl, sz, 0)
        stop = stop | ~defl
    return Hw, Qw, hw, nd, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_aed_is_bitwise_the_old_loop(monkeypatch, dtype):
    a = torch.from_numpy(_kinds(32, 4)).to(dtype)
    H, Q, hi, stag, anorm, _ = ts._schur_init(a, with_q=True)
    state = (H, Q, hi, stag, anorm, torch.zeros(4, dtype=torch.bool),
             torch.zeros((), dtype=torch.long))
    H, Q, hi, stag, anorm = ts._schur_sweeps(state, 3, npairs=2, aed_w=W)[:5]
    args = (H, Q, hi, stag, anorm, W, 2, True)
    new = ts._aed(*args)
    monkeypatch.setattr(sw, "window_schur", _old_window)
    old = ts._aed(*args)
    flat = [[*r[:4], *r[4], r[5]] for r in (new, old)]
    assert len(flat[0]) == 8
    for got, want in zip(*flat):
        assert torch.equal(got, want)
    assert (new[2] < hi).any()


def test_wrapper_checks_and_mirrors():
    Hw, Qw, hw, an, beta, hi_w0, n = _jax_windows()
    before = Hw.clone()
    got = sw.window_schur(Hw, Qw, hw, an, beta, hi_w0, n)
    want = sw.window_schur_reference(Hw, Qw, hw, an, beta, hi_w0, n)
    assert len(got) == 5
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert torch.equal(Hw, before) and not torch.equal(got[0], before)
    with pytest.raises(ValueError, match="Qw must be"):
        sw.window_schur(Hw, Qw[:, :, :-1], hw, an, beta, hi_w0, n)
    with pytest.raises(ValueError, match="hw must be"):
        sw.window_schur(Hw, Qw, hw.int(), an, beta, hi_w0, n)
    with pytest.raises(ValueError, match="beta must be"):
        sw.window_schur(Hw, Qw, hw, an, beta[:-1], hi_w0, n)
    with pytest.raises(ValueError, match="hi_w0 must be"):
        sw.window_schur(Hw, Qw, hw, an, beta, hi_w0.int(), n)
    # the kernel's shared memory (csrc/schur_window.cu window_bytes)
    assert sw.smem_bytes(32, torch.float32) == 9120
    assert sw.smem_bytes(64, torch.float64) == 68640
    assert sw.fits(118, torch.float64) and not sw.fits(119, torch.float64)
    assert sw.fits(127, torch.float32) and not sw.fits(128, torch.float32)
    # the chase's variants (csrc/schur_chase.cu chase_variant): the
    # cluster from n = 128, two blocks in f32 at n = 256, four in f64
    assert [sc.variant(n, torch.float32) for n in (64, 127, 128, 256)] == [
        0, 0, 1, 1]
    assert sc.cluster_size(256, torch.float32) == 2
    assert sc.cluster_size(256, torch.float64) == 4
    assert sc.cluster_size(512, torch.float32) == 0
    assert sc.variant(512, torch.float32) == 0


REEXPORTED = {
    "rref": ["EV_ELIM_ABOVE", "EV_ELIM_BELOW", "EV_NORM", "EV_SWAP",
             "EVENT_NAMES", "RREFResult", "rref", "rref_batched"],
    "solve": ["BatchedAffineSubspace", "InverseResult", "det_gj",
              "det_gj_batched", "inverse", "inverse_batched", "nullspace",
              "nullspace_batched", "rank", "rank_batched", "solve",
              "solve_batched"],
    "lu": ["LUResult", "det_lu", "det_lu_batched", "lu_factor",
           "lu_factor_batched", "lu_solve", "lu_solve_batched", "solve_lu",
           "solve_lu_batched"],
    "rref_blocked": ["BlockedRREF", "rank_blocked_batched", "rref_blocked",
                     "solve_affine_blocked_batched"],
}


def test_ops_surface_reexports_the_reference_names(monkeypatch):
    ops = importlib.import_module("linalg_solver_tpu_torch.ops")
    ref = importlib.import_module("linalg_solver_tpu.ops")
    for mod, names in REEXPORTED.items():
        module = importlib.import_module(f"linalg_solver_tpu_torch.ops.{mod}")
        for name in names:
            assert getattr(ops, name) is getattr(module, name), name
            assert hasattr(ref, name), name
    # as in the reference, three functions shadow their modules' names
    for name in ("rref", "solve", "rref_blocked"):
        assert callable(getattr(ops, name))
    from linalg_solver_tpu_torch.ops import dispatch

    solve = importlib.import_module("linalg_solver_tpu_torch.ops.solve")
    assert dispatch._solve is solve
    assert dispatch._rrb is importlib.import_module(
        "linalg_solver_tpu_torch.ops.rref_blocked")
    # the "loop" inverse and the affine solve run through the module
    calls = []
    for name in ("inverse_batched", "solve_batched"):
        orig = getattr(solve, name)
        monkeypatch.setattr(solve, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(2, 5, 5).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, 5).astype(np.float32))
    x = dispatch.inverse_batched(a, backend="loop")
    assert torch.allclose(x @ a, torch.eye(5).expand(2, 5, 5), atol=1e-4)
    res = dispatch.affine_solve_batched(a, b, backend="loop")
    assert bool(res.is_consistent.all())
    assert calls == ["inverse_batched", "solve_batched"]
