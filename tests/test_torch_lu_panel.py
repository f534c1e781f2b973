"""The port's masked partial-pivot panel LU (``linalg_solver_tpu_torch.ops
.kernels.lu_panel``) against the JAX package's Pallas kernel
``ops.pallas.lu_panel_kernel.panel_factor_masked`` in interpret mode, on
the same numpy panels.

On the CPU the wrapper runs its plain version: one sequential step per
column.  The JAX kernel folds two steps into one pass over the panel,
which on finite panels rounds exactly as the sequential steps do, so all
five outputs agree to the bit.  A NaN carries garbage whose placement
depends on that fold; there ``ok``, ``piv_step`` and the mask agree."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops.pallas import lu_panel_kernel as jlp
from linalg_solver_tpu_torch.ops.kernels import lu_panel

_NAMES = ("panel_u", "piv_step", "piv_row", "pivoted_out", "ok")


def _inputs(B, n, nb, marked, seed):
    """Gaussian panels and a mask with ``marked`` rows pre-pivoted in each
    panel; panel 0's column 1 is zero (no pivot at step 1)."""
    rng = np.random.RandomState(seed)
    p = rng.randn(B, n, nb).astype(np.float32)
    m = np.zeros((B, n), np.int32)
    for b in range(B):
        m[b, rng.choice(n, marked, replace=False)] = 1
    p[0, :, 1] = 0.0
    return p, m


def _both(p, m, nb):
    rj = [np.asarray(x) for x in jlp.panel_factor_masked(
        jnp.asarray(p), jnp.asarray(m), nb, interpret=True)]
    before = lu_panel.LAUNCHES
    rt = lu_panel.panel_factor_masked(torch.from_numpy(p),
                                      torch.from_numpy(m), nb)
    assert lu_panel.LAUNCHES == before       # CPU: the plain version
    return rj, [x.numpy() for x in rt]


def _nan_equal(x, y):
    return bool(((x == y) | (np.isnan(x) & np.isnan(y))).all())


@pytest.mark.parametrize("n,nb,marked", [(16, 4, 0), (16, 4, 5), (64, 16, 0),
                                         (64, 16, 24)])
def test_matches_jax_kernel_bitwise(n, nb, marked):
    p, m = _inputs(4, n, nb, marked, seed=n + nb + marked)
    rj, rt = _both(p, m, nb)
    for name, x, y in zip(_NAMES, rt, rj):
        assert x.shape == y.shape, name
        assert _nan_equal(x, y), name
    assert rt[1].dtype == rt[2].dtype == rt[3].dtype == np.int32
    assert rt[4].tolist() == [False, True, True, True]
    # the pre-pivoted rows are neither pivots nor eliminated
    assert (rt[3][m > 0] == 1).all() and (rt[1][m > 0] == n).all()
    assert np.array_equal(rt[0][m > 0], p[m > 0])


def test_nan_lane_agrees_on_flags_and_mask():
    p, m = _inputs(3, 64, 16, 10, seed=3)
    p[1, 5, 2] = np.nan
    p[2, np.flatnonzero(m[2])[0], 7] = np.nan     # in a pre-pivoted row
    rj, rt = _both(p, m, 16)
    assert rt[4].tolist() == rj[4].tolist() == [False, False, False]
    for i in (1, 3):
        assert np.array_equal(rt[i], rj[i]), _NAMES[i]
    assert _nan_equal(rt[0][0], rj[0][0])


def test_factors_the_unpivoted_rows():
    """Unmasked, the panel's pivot rows in step order hold L\\U of the
    matrix rows they came from: P·panel = L·U on the leading block."""
    n, nb = 24, 8
    p, m = _inputs(2, n, nb, 0, seed=9)
    p[0, :, 1] += 1.0                         # no zero column here
    pu, step, row, mask, ok = lu_panel.panel_factor_masked(
        torch.from_numpy(p), torch.from_numpy(m), nb)
    assert ok.tolist() == [True, True]
    assert torch.equal(torch.sort(step, dim=1).values[:, :nb],
                       torch.arange(nb, dtype=torch.int32).expand(2, nb))
    for b in range(2):
        packed = pu[b][row[b].long()].double()
        lo = torch.tril(packed, -1) + torch.eye(nb, dtype=torch.float64)
        ref = torch.from_numpy(p[b])[row[b].long()].double()
        np.testing.assert_allclose((lo @ torch.triu(packed)).numpy(),
                                   ref.numpy(), atol=1e-5 * np.abs(p).max())


def test_odd_or_narrow_nb_raises():
    for nb in (1, 3):
        with pytest.raises(ValueError, match="even nb"):
            lu_panel.panel_factor_masked(torch.zeros(1, 8, nb),
                                         torch.zeros(1, 8), nb)
    with pytest.raises(ValueError, match="pivoted must be"):
        lu_panel.panel_factor_masked(torch.zeros(1, 8, 4),
                                     torch.zeros(1, 7), 4)
    with pytest.raises(ValueError, match="N >= nb"):
        lu_panel.panel_factor_masked(torch.zeros(1, 2, 4),
                                     torch.zeros(1, 2), 4)


def test_smem_mirror_and_fits():
    """The panel with column stride n + 1, the staged pivot row, two
    per-column counts, the row state and the argmax slots."""
    assert lu_panel.smem_bytes(256, 64) == 4 * (64 * 257 + 3 * 64 + 256 + 16)
    assert lu_panel.fits(889, 64) and not lu_panel.fits(890, 64)
    assert lu_panel.fits(960, 32) and lu_panel.fits(1756, 32)
    assert not lu_panel.fits(1757, 32) and not lu_panel.fits(64, 3)
    assert lu_panel.fits(4, 4) and not lu_panel.fits(2, 4)     # N >= nb
