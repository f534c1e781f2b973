"""The probe systems of ``linalg_solver_tpu_torch.utils.systems`` do what
``chip_smoke.py`` and ``test_torch_cuda.py`` rely on, checked on the
port's plain version: the zero-minor system is flagged without the
butterfly and solved with it, the small-pivot system is solved to f32
accuracy only with refinement, and the zero-pivot system defeats only
the draw it was built for."""

import numpy as np
import pytest
import torch

from linalg_solver_tpu_torch.ops import rbt
from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf
from linalg_solver_tpu_torch.utils import systems


def _w(n, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        (rng.randn(n, n) + 4.0 * np.sqrt(n) * np.eye(n)).astype(np.float32))


def _rhs(n, seed, k=1):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(1, n, k).astype(np.float32))


def _rel_err(a, b, x):
    want = np.linalg.solve(a.double().numpy(), b.double().numpy())
    return float(np.abs(x.double().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", [64, 98])
def test_zero_minor_system_needs_the_butterfly(n):
    s = systems.zero_minor_system(_w(n, n))
    assert torch.equal(s[:16, :16], torch.zeros(16, 16))
    assert np.linalg.cond(s.double().numpy()) < 5.0
    _, _, ok = sf._lu_nopivot(s[None].clone())
    assert float(ok[0]) == 0.0          # no butterfly: zero pivot
    U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    b = _rhs(n, 1)
    x, bad = sf.solve_fused_rbt_reference(s[None], b, U, V)
    assert not bad.any()
    assert _rel_err(s[None], b, x) < 1e-6


@pytest.mark.parametrize("n,k", [(64, 1), (64, 8), (98, 1)])
def test_small_pivot_system_needs_refinement(n, k):
    U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    s = systems.pivot_system(_w(n, n + k), U, V, 1e-3)[None]
    d = rbt.shrink_depth(n)
    m = rbt.butterfly_apply(s.double(), U[:d].double(), trans=True)
    m = rbt.butterfly_apply(m.transpose(1, 2), V[:d].double(), trans=True)
    assert abs(float(m[0, 0, 0]) - 1e-3) < 1e-5   # Uᵀ A V's first pivot
    assert np.linalg.cond(s[0].double().numpy()) < 5.0
    b = _rhs(n, 2, k)
    x0, bad0 = sf.solve_fused_rbt_reference(s, b, U, V, ir_steps=0)
    x2, bad2 = sf.solve_fused_rbt_reference(s, b, U, V, ir_steps=2)
    assert not bad0.any() and not bad2.any()
    assert _rel_err(s, b, x0) > 1e-4     # growth: unrefined is far off
    assert _rel_err(s, b, x2) < 1e-6     # refined: f32 accuracy


def test_zero_pivot_system_defeats_only_its_draw():
    n = 64
    U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    R, S = rbt.default_diags(n, rbt.RESCUE_SEEDS, "cpu")
    s = systems.pivot_system(_w(n, 3), U, V, 0.0)[None]
    b = _rhs(n, 4)
    _, bad = sf.solve_fused_rbt_reference(s, b, U, V)
    assert bad.tolist() == [True]
    x, bad = sf.solve_fused_rbt_reference(s, b, R, S)
    assert bad.tolist() == [False]
    assert _rel_err(s, b, x) < 1e-6


def test_zero_minor_system_rejects_a_minor_past_half():
    with pytest.raises(ValueError, match="m=40"):
        systems.zero_minor_system(_w(64, 0), m=40)
