"""The port's no-pivot panel LU (``linalg_solver_tpu_torch.ops.kernels
.lu_nopivot``) against the JAX package's Pallas kernel
``ops.pallas.lu_nopivot_kernel.panel_factor_nopivot`` in interpret mode,
on the same numpy panels.

On the CPU the wrapper runs its plain version.  The JAX kernel folds
``lookahead`` steps into one pass over the panel, which may round the
trailing update differently, so values agree to rtol 1e-5 of each
panel's largest entry; the ``ok`` flags agree exactly.  A panel with a
NaN carries garbage whose NaN pattern depends on that folding (the JAX
kernel's masked update reaches columns left of the current step): there
both must be flagged and non-finite."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops.pallas import lu_nopivot_kernel as jlu
from linalg_solver_tpu_torch.ops.kernels import lu_nopivot


def _panels(m, nb, seed):
    """Four [m, nb] panels with dominant pivots: 0 clean, 1 a zero pivot
    at step 3 (its column zero), 2 a NaN that reaches a pivot, 3 an Inf
    in the last row."""
    rng = np.random.RandomState(seed)
    p = rng.randn(4, m, nb).astype(np.float32)
    p[:, np.arange(nb), np.arange(nb)] += 4.0 * np.sqrt(nb)
    p[1, :, 3] = 0.0
    p[2, 5, 1] = np.nan
    p[3, m - 1, 2] = np.inf
    return p


@pytest.mark.parametrize("nb", [8, 16, 32])
@pytest.mark.parametrize("m", [32, 64])
def test_matches_jax_kernel(m, nb):
    p = _panels(m, nb, seed=m + nb)
    pj, okj = jlu.panel_factor_nopivot(jnp.asarray(p), nb, interpret=True)
    pj, okj = np.asarray(pj), np.asarray(okj)
    before = lu_nopivot.LAUNCHES
    pt, okt = lu_nopivot.panel_factor_nopivot(torch.from_numpy(p), nb)
    assert lu_nopivot.LAUNCHES == before        # CPU: the plain version
    assert okt.dtype == torch.bool and pt.shape == p.shape
    assert okt.tolist() == okj.tolist()
    assert okt.tolist()[:3] == [True, False, False]
    pt = pt.numpy()
    for i in (0, 1):
        np.testing.assert_allclose(pt[i], pj[i], rtol=1e-5,
                                   atol=1e-5 * np.abs(pj[i]).max())
    for i in (2, 3):
        assert not np.isfinite(pt[i]).all() and not np.isfinite(pj[i]).all()
    # the zero pivot: multipliers below it zero, the rest of U kept
    assert (pt[1, 4:, 3] == 0.0).all() and pt[1, 3, 3] == 0.0


def test_square_panel_is_the_lu_factorization():
    """One panel of width M: L (unit lower) times U gives the panel back."""
    n = 24
    p = _panels(n, n, seed=5)[0]
    pu, ok = lu_nopivot.panel_factor_nopivot(torch.from_numpy(p)[None], n)
    assert ok.tolist() == [True]
    lu = pu[0].double()
    lo = torch.tril(lu, -1) + torch.eye(n, dtype=torch.float64)
    np.testing.assert_allclose((lo @ torch.triu(lu)).numpy(), p, rtol=0,
                               atol=1e-5 * np.abs(p).max())


def test_nan_pivot_is_flagged_and_spreads():
    """A NaN pivot counts as zero (flagged), and its NaN reaches the
    multipliers of the whole column and the columns right of it."""
    p = _panels(16, 8, seed=6)[:1].copy()
    p[0, 2, 2] = np.nan
    pu, ok = lu_nopivot.panel_factor_nopivot(torch.from_numpy(p), 8)
    assert ok.tolist() == [False]
    assert torch.isnan(pu[0, 3:, 2]).all() and torch.isnan(pu[0, :, 3:]).all()
    assert torch.isfinite(pu[0, :, :2]).all()


def test_smem_mirror_and_fits():
    """The panel with column stride m + 1 plus the staged pivot row."""
    assert lu_nopivot.smem_bytes(256, 64) == 4 * (64 * 257 + 64)
    assert lu_nopivot.fits(906, 64) and not lu_nopivot.fits(907, 64)
    assert lu_nopivot.fits(896, 64) and lu_nopivot.fits(1016, 8)
    assert not lu_nopivot.fits(4, 8)          # m >= nb
    with pytest.raises(ValueError, match="nb=8"):
        lu_nopivot.panel_factor_nopivot(torch.zeros(2, 16, 4), 8)
