"""The AED window kernel's dead-step rule, written plainly
(``kernels.schur_window.window_schedule_reference``), against the full
plain version (``window_schur_reference`` → ``ops.schur._window_schur``)
on the CPU: equal up to the sign of a zero (NaN-equal) on windows of
``torch_schur_cases``' kinds (the JAX solver's state three sweeps in),
with a lane converged on entry, a NaN lane, an Inf lane and a lane scaled
so that a dead step's sums overflow; and the live steps it counts against
every step on windows built as ``chip_smoke.py`` builds its w = 32 ones
(the first AED round of seeded Gaussian 256 × 256 matrices)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from linalg_solver_tpu_torch.ops import schur as ts
from linalg_solver_tpu_torch.ops.kernels import schur_window as sw
from torch_schur_cases import _kinds, _swept_state

W = 8


def _nan_equal(x, y):
    return bool(((x == y) | (x.isnan() & y.isnan())).all())


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


def _kind_windows(dtype):
    """The windows of the four kinds (Gaussian, skew, Jordan, companion)
    at n = 32, three sweeps in, every lane live."""
    H, _, hi, _, _, _ = _swept_state(_kinds(32, 4), 3, 2, W)
    return _windows(torch.from_numpy(H.copy()).to(dtype),
                    torch.from_numpy(hi.copy()).long())


def _case(kind, dtype):
    Hw, Qw, hw, an, beta, hi_w0, n = _kind_windows(dtype)
    Hw, hw, an = Hw.clone(), hw.clone(), an.clone()
    if kind == "converged":
        hw[1], hw[2] = 0, -1
    elif kind == "nan":
        Hw[0, 3, 5] = float("nan")
    elif kind == "inf":
        Hw[3, 2, 4] = float("inf")
    elif kind == "scaled":
        # past the rule's bound: x^2 and v0 h0 overflow in the dead steps
        s = 1e19 if dtype == torch.float32 else 1e155
        Hw[1] *= s
        an[1] *= s
    return Hw, Qw, hw, an, beta, hi_w0, n


@pytest.mark.parametrize("kind,dtype", [
    ("kinds", torch.float32), ("converged", torch.float32),
    ("nan", torch.float32), ("inf", torch.float32),
    ("scaled", torch.float32), ("kinds", torch.float64),
    ("scaled", torch.float64)])
def test_schedule_matches_plain(kind, dtype):
    args = _case(kind, dtype)
    want = sw.window_schur_reference(*args)
    got = sw.window_schedule_reference(*args)
    for g, w_ in zip(got[:5], want):
        assert _nan_equal(g, w_)
    steps = got[5]
    assert steps.shape == (4,) and bool((steps >= 0).all())
    if kind in ("nan", "inf"):
        assert bool(torch.isnan(got[0][0 if kind == "nan" else 3]).any())
    if kind == "scaled":
        # lane 1 never skips: every step of each sweep it runs
        assert bool(torch.isnan(got[0][1]).any()) and int(got[2][1]) >= 1
        assert int(steps[1]) == 2 * W * (W - 1)


def test_counts_only_the_sweeps_the_kernel_runs():
    """A lane converged on entry runs one sweep where the batch is live
    (none of its steps active: its dead steps are skipped but p = 0's);
    a batch with no live lane runs none."""
    Hw, Qw, hw, an, beta, hi_w0, n = _kind_windows(torch.float32)
    hw = hw.clone()
    hw[1] = -1
    got = sw.window_schedule_reference(Hw, Qw, hw, an, beta, hi_w0, n)
    assert int(got[5][1]) == 1
    idle = sw.window_schedule_reference(Hw[1:2], Qw[1:2], hw[1:2], an[1:2],
                                        beta[1:2], hi_w0[1:2], n)
    assert int(idle[5][0]) == 0 and torch.equal(idle[0], Hw[1:2])


def test_keys_order_magnitudes_and_bound():
    for dtype, bound in ((torch.float32, 2.0 ** 60), (torch.float64,
                                                      2.0 ** 500)):
        x = torch.tensor([[0.0, -0.0, 1.0, -3.5, bound * 0.75, bound, -bound,
                           float("inf"), float("nan")]], dtype=dtype)
        keys = [int(sw._mag_key(x[:, :i + 1])) for i in range(x.shape[1])]
        assert keys == sorted(keys)
        below = [int(sw._mag_key(v.reshape(1, 1))) < sw.SKIP_BOUND[dtype]
                 for v in x[0]]
        assert below == [True] * 5 + [False] * 4


def test_live_steps_on_the_chip_smoke_windows(capsys):
    """The first AED round's windows of seeded Gaussian 256 × 256 matrices
    (w = 32, as ``chip_smoke.py`` records them at B = 32; here 4 lanes):
    the rule skips part of the steps and leaves the result as it was."""
    rng = np.random.RandomState(2026)
    a = torch.from_numpy(rng.randn(4, 256, 256).astype(np.float32))
    npairs, aed_w = ts._sweep_config(256, 0, -1)
    H, Q, hi, st, an, _ = ts._schur_init(a)
    state = (H, Q, hi, st, an, torch.zeros_like(hi, dtype=torch.bool),
             torch.zeros((), dtype=torch.long))
    rec, orig = [], sw.window_schur

    def record(*args):
        rec.append(args)
        return orig(*args)

    sw.window_schur = record
    try:
        ts._schur_sweep(state, npairs, aed_w)
    finally:
        sw.window_schur = orig
    args = rec[0]
    assert tuple(args[0].shape) == (4, 33, 33)
    got = sw.window_schedule_reference(*args)
    want = sw.window_schur_reference(*args)
    for g, w_ in zip(got[:5], want):
        assert _nan_equal(g, w_)
    live = int(got[5].sum())
    # every step of every sweep each lane runs (the kernel stops a lane at
    # hw < 1): the plain batch loop's live sweeps
    sweeps, h, stg, Hc, Qc = 0, args[2], torch.zeros_like(args[2]), args[0], \
        args[1]
    for _ in range(2 * 32):
        on = h >= 1
        if not bool(on.any()):
            break
        sweeps += int(on.sum())
        Hc, h, stg, Qc, _ = ts._one_sweep(Hc, h, stg, args[3], Qc,
                                          strict_deflate=True)
    every = sweeps * 31
    with capsys.disabled():
        print(f"\nwindow steps run {live} of {every} ({live / every:.4f})")
    assert 0 < live < every
