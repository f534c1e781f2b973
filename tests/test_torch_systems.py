"""The probe systems of ``linalg_solver_tpu_torch.utils.systems`` do what
``chip_smoke.py`` and ``test_torch_cuda.py`` rely on, checked on the
port's plain versions: the zero-minor system is flagged without the
butterfly and solved with it, the small-pivot system is solved to f32
accuracy only with refinement, the zero-pivot system defeats only the
draw it was built for, and the two-draw system defeats both draws of
the inverse and is left to its pivoted level."""

import numpy as np
import pytest
import torch

from linalg_solver_tpu_torch.ops import rbt
from linalg_solver_tpu_torch.ops.kernels import inv_rbt
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


def _first_pivot(s, U, V):
    """(Uᵀ A V)[0, 0] in float64."""
    d = rbt.shrink_depth(s.shape[-1])
    m = rbt.butterfly_apply(s.double(), U[:d].double(), trans=True)
    m = rbt.butterfly_apply(m.transpose(1, 2), V[:d].double(), trans=True)
    return float(m[0, 0, 0])


_PIVOT_CASES = [(n, k, seed) for n, k in [(64, 1), (64, 8), (98, 1)]
                for seed in (0, 1000, 2000)]


@pytest.mark.parametrize(
    "n,k,seed", _PIVOT_CASES,
    ids=[f"{n}-{k}" + (f"-seed{seed}" if seed else "")
         for n, k, seed in _PIVOT_CASES],
)
def test_small_pivot_system_needs_refinement(n, k, seed):
    """Three matrices per shape: the unrefined error depends on the
    matrix, so a marginal one shows here and not only on a card.  The
    loose ir_steps=0 gate may flag the unrefined solve; flagged or not,
    its values are off by > 1e-4 on every seed, and that value gap is
    what the card's control reads.  The refined solve is never
    flagged."""
    U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    s = systems.pivot_system(_w(n, n + k + seed), U, V,
                             systems.SMALL_PIVOT)[None]
    assert abs(_first_pivot(s, U, V) - systems.SMALL_PIVOT) < 1e-5
    assert np.linalg.cond(s[0].double().numpy()) < 5.0
    b = _rhs(n, 2, k)
    x0, bad0 = sf.solve_fused_rbt_reference(s, b, U, V, ir_steps=0)
    x2, bad2 = sf.solve_fused_rbt_reference(s, b, U, V, ir_steps=2)
    assert not bad2.any()
    # growth: unrefined is far off, whatever bad0 says
    assert _rel_err(s, b, x0) > 1e-4, bool(bad0[0])
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


@pytest.mark.parametrize("n", [16, 64, 128])
def test_two_draw_zero_pivot_system_needs_the_pivoted_level(n):
    UV = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    RS = rbt.default_diags(n, rbt.RESCUE_SEEDS, "cpu")
    w = _w(n, 5)
    s = systems.two_draw_zero_pivot_system(w, UV, RS)
    scale = float(w.abs().max())
    assert abs(_first_pivot(s[None], *UV)) < 1e-6 * scale
    assert abs(_first_pivot(s[None], *RS)) < 1e-6 * scale
    assert (s - torch.roll(w, 1, dims=0)).abs().max() < 0.1 * scale
    assert np.linalg.cond(s.double().numpy()) < 5.0
    probe = rbt.default_probe(n, "cpu")
    _, bad1 = inv_rbt._nopivot_pass(s[None], *UV, probe)
    _, bad2 = inv_rbt._nopivot_pass(s[None], *RS, probe)
    assert bad1.tolist() == bad2.tolist() == [True]
    x, bad = inv_rbt.inverse_rbt_fused_reference(s[None], UV, RS, probe)
    assert bad.tolist() == [True]        # level 3 keeps the flag
    r = s.double() @ x[0].double() - torch.eye(n, dtype=torch.float64)
    assert float(r.abs().max()) < 1e-5


def test_two_draw_zero_pivot_system_without_its_correction_passes():
    """The rolled matrix alone is inverted at level 1: the correction
    terms, not the roll, defeat the draws."""
    n = 64
    UV = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    rolled = torch.roll(_w(n, 5), 1, dims=0)[None]
    _, bad = inv_rbt._nopivot_pass(rolled, *UV, rbt.default_probe(n, "cpu"))
    assert bad.tolist() == [False]
