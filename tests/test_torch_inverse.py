"""The port's fused RBT inverse (``linalg_solver_tpu_torch.ops.kernels
.inv_rbt``) against the JAX package's Pallas kernel in interpret mode,
fed the same numpy inputs and the JAX draws: butterflies from keys 17/29
(main) and 101/103 (rescue), the Rademacher probe from key 83.  On the
CPU the port runs its plain version; ``test_torch_cuda.py`` holds the
CUDA kernel against it on a card.

The probe batch (``utils.systems.inverse_probe_batch``) puts one matrix
on every rung of the rescue ladder, so that a kernel missing any part
disagrees with the reference:

- 0, 7: clean (level 1);
- 1: all zero (flagged, finite garbage);
- 2: a NaN (flagged, non-finite);
- 3: a zero leading minor (level 1 only with the butterfly);
- 4: first pivot 1e-6 under the main draw (only the probe rejects the
  level-1 X; the redraw inverts it);
- 5: first pivot 0 under the main draw (the redraw inverts it);
- 6: first pivot 0 under both draws (level 3: correct X, flag True).

Tolerance: flags exactly; X per matrix to 1e-5 of its largest entry.
The eliminations run the same f32 operations in the same order; the
butterflies' and probes' sums may round differently (XLA fuses some of
them), which moves X by a few roundings of a well-conditioned inverse.

Some of its cases live in ``tests/test_torch_inverse_probe.py`` (files
of at most 11 tests: pytest-xdist's ``--dist loadfile`` queues a file by
its number of tests, and so queues these after the slow JAX file
``tests/test_lu_large.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu.ops.pallas import inv_rbt_kernel as jinv
from linalg_solver_tpu_torch.ops import rbt
from linalg_solver_tpu_torch.ops.kernels import inv_rbt
from linalg_solver_tpu_torch.utils import systems

RTOL = 1e-5
FINAL_BAD = systems.INVERSE_FLAGGED
LEVEL1_BAD = [1, 2, 4, 5, 6]


def _jax_diags(n, keys):
    d = rbt.shrink_depth(n)
    return rbt.diags_from_numpy(*(
        [np.asarray(v) for v in jrbt.rbt_diags(
            jax.random.PRNGKey(key), n, d, jnp.float32)]
        for key in keys
    ))


def _jax_draws(n):
    probe = jax.random.rademacher(jax.random.PRNGKey(83), (n,), jnp.int8)
    return (_jax_diags(n, rbt.MAIN_SEEDS), _jax_diags(n, rbt.RESCUE_SEEDS),
            rbt.probe_from_numpy(np.asarray(probe)))


def _probe_batch(n, draw, redraw, seed=0):
    """``systems.inverse_probe_batch`` on a numpy-made batch."""
    rng = np.random.RandomState(seed + n)
    a = torch.from_numpy(
        (rng.randn(8, n, n) + 4.0 * np.sqrt(n) * np.eye(n)).astype(
            np.float32))
    return systems.inverse_probe_batch(a, draw, redraw).numpy()


def _jax(a, **kw):
    x, bad = jinv.inverse_rbt_fused_batched(
        jnp.asarray(a), interpret=True, return_flags=True, **kw)
    return np.asarray(x), np.asarray(bad)


def _port(a, draws, **kw):
    draw, redraw, probe = draws
    x, bad = inv_rbt.inverse_rbt_fused_batched(
        torch.from_numpy(a), return_flags=True, diags=draw,
        rescue_diags=redraw, probe=probe, **kw)
    return x.numpy(), bad.numpy()


def _assert_close(xj, xt, mats):
    for i in mats:
        assert np.isfinite(xt[i]).all(), i
        err = np.abs(xt[i] - xj[i]).max()
        assert err <= RTOL * np.abs(xj[i]).max(), (i, err)


def _resid(a, x):
    n = a.shape[-1]
    r = np.einsum("bij,bjk->bik", a.astype(np.float64),
                  x.astype(np.float64)) - np.eye(n)
    return np.abs(r).max(axis=(1, 2))


def test_every_level_of_the_ladder_is_reached():
    n = 32
    draw, redraw, probe = _jax_draws(n)
    a = torch.from_numpy(_probe_batch(n, draw, redraw))
    _, bad1 = inv_rbt.inverse_rbt_fused(a, draw, redraw, probe, rescue=False)
    assert np.flatnonzero(bad1.numpy()).tolist() == LEVEL1_BAD
    # with a zero probe only zero pivots flag: 4's pivot is not zero,
    # its level-1 X is rejected by the probe alone
    _, pivot_only = inv_rbt.inverse_rbt_fused(
        a, draw, redraw, torch.zeros(n), rescue=False)
    assert not bool(pivot_only[4]) and bool(pivot_only[1])
    _, bad2 = inv_rbt._nopivot_pass(a, *redraw, probe)
    assert np.flatnonzero(bad2.numpy()).tolist() == FINAL_BAD
    x, bad = inv_rbt.inverse_rbt_fused(a, draw, redraw, probe)
    assert np.flatnonzero(bad.numpy()).tolist() == FINAL_BAD
    r = _resid(a.numpy(), x.numpy())
    assert r[[4, 5]].max() <= 1e-3   # redraw: no refinement behind it
    assert r[6] <= 1e-5              # level 3, still flagged


@pytest.mark.parametrize(
    "kw", [{"gate_mode": "full"}, {"ns_steps": 1}, {"fallback": False}],
    ids=["full_gate", "ns_steps_1", "no_fallback"],
)
def test_options_match_jax(kw):
    """Outside the default the kernel runs without its rescue; the full
    gate and the pivoted inverse of the flagged matrices follow it."""
    n = 32
    draws = _jax_draws(n)
    a = _probe_batch(n, *draws[:2], seed=1)
    xj, bj = _jax(a, **kw)
    xt, bt = _port(a, draws, **kw)
    np.testing.assert_array_equal(bt, bj)
    assert np.flatnonzero(bt).tolist() == LEVEL1_BAD
    if kw.get("fallback", True):
        _assert_close(xj, xt, [0, 1, 3, 4, 5, 6, 7])
        assert _resid(a[[0, 3, 4, 5, 6, 7]], xt[[0, 3, 4, 5, 6, 7]]).max() \
            <= 5e-5
    else:
        _assert_close(xj, xt, [0, 3, 7])
    assert not np.isfinite(xt[2]).all()


def test_ns_polish_improves():
    rng = np.random.RandomState(3)
    n = 32
    a = (rng.randn(4, n, n) + 3 * np.sqrt(n) * np.eye(n)).astype(np.float32)

    def err_of(ns):
        x = inv_rbt.inverse_rbt_fused_batched(torch.from_numpy(a),
                                              ns_steps=ns)
        return _resid(a, x.numpy()).max()

    assert err_of(1) <= err_of(0) * 1.5
    assert err_of(1) < 5e-6


def test_default_draws_and_probe():
    n = 64
    v = rbt.default_probe(n, "cpu")
    assert v.dtype == torch.float32 and v.shape == (n,)
    assert set(v.tolist()) == {-1.0, 1.0}
    g = torch.Generator().manual_seed(rbt.PROBE_SEED)
    want = 2.0 * torch.randint(0, 2, (n,), generator=g) - 1.0
    assert torch.equal(v, want.float())
    a = np.random.RandomState(2).randn(3, n, n) + 4 * np.sqrt(n) * np.eye(n)
    x = inv_rbt.inverse_rbt_fused_batched(torch.from_numpy(a))
    assert x.dtype == torch.float64       # returned in the input's dtype
    assert _resid(a, x.numpy()).max() <= 5e-5


def test_reach_and_rejections():
    assert inv_rbt.fits(4) and inv_rbt.fits(128) and inv_rbt.fits(164)
    assert inv_rbt.fits(168) and inv_rbt.fits(180)
    assert not inv_rbt.fits(184) and not inv_rbt.fits(170)
    assert not inv_rbt.fits(66)
    # variant 3 (8 warps): the 64 x 65 tile, 12 n floats of buffers, the
    # block-max slots and the flag
    assert inv_rbt.smem_bytes(64) == 4 * (64 * 65 + 12 * 64 + 8 + 1)
    with pytest.raises(ValueError, match="gate_mode"):
        inv_rbt.inverse_rbt_fused_batched(torch.zeros(1, 8, 8),
                                          gate_mode="exact")
    with pytest.raises(ValueError, match="even N"):
        inv_rbt.inverse_rbt_fused_batched(torch.zeros(1, 7, 7))


def test_reach_is_the_references():
    assert [n for n in range(1, 401) if inv_rbt.fits(n)] == \
        [n for n in range(1, 401) if jinv.supported(n)]


@pytest.mark.parametrize("n", [8, 36])
def test_in_place_elimination_is_the_span_form_bitwise(n):
    """Slot c holds A'-column c until step c, then I-column n + c: the
    same bits as the TPU kernel's [n, 2n] span, a NaN, an Inf, a zero
    pivot and a zero matrix included."""
    rng = np.random.RandomState(n)
    w = torch.from_numpy((rng.randn(6, n, n) + 2.0 * np.eye(n)).astype(
        np.float32))
    w[1, 2, 3] = float("nan")
    w[2, 0, 5] = float("inf")
    w[3, 0, 0] = 0.0
    w[4] = 0.0
    w[5, : n // 2, : n // 2] = 0.0
    x, ok = inv_rbt._eliminate(w)
    y, ok_span = inv_rbt._eliminate_span(w)
    assert torch.equal(ok, ok_span)
    assert ok.tolist() == [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    assert bool(((x == y) | (x.isnan() & y.isnan())).all())
    assert torch.equal(x.isnan(), y.isnan())
    assert bool(x[1].isnan().any()) and bool(x[0].isfinite().all())
