"""The reach and variant choice of the pivot-free kernels (the fused RBT
solve, ``ops/kernels/solve_fused``, the no-pivot panel LU,
``ops/kernels/lu_nopivot``, and the fused RBT inverse,
``ops/kernels/inv_rbt``), on the CPU.

The wrappers choose a kernel variant by shape alone, and their
``smem_bytes`` / ``fits`` / ``variant`` mirror C formulas in
``csrc/solve_fused.cu``, ``csrc/lu_nopivot.cu`` and ``csrc/inv_rbt.cu``.  The formulas are
written out here once more, so that a change on either side shows: the
reach (``fits``) is the device-memory variant's and the shared-memory
panel's, as before the register and on-chip variants, and the routes
that follow from it do not move.  The plain no-pivot panel without its
one-hot pivot rule (the control of the card checks) is held apart from
the plain version on the panels that tell them apart.
"""

import pytest
import torch

from linalg_solver_tpu_torch.ops import dispatch
from linalg_solver_tpu_torch.ops.kernels import inv_rbt, lu_nopivot
from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf

MAX_SMEM = 232448  # bytes of shared memory a block may take on sm_90


def fused_smem_floats(n, k):
    """csrc/solve_fused.cu `smem_floats` (variant 0): the panel P and U12
    (at least a 32 x 33 transpose tile), du and dv, four k·n vectors,
    ipiv, the eight warps' reduction slots."""
    return max(2 * 32 * n, 32 * 33) + 4 * n + 4 * k * n + n + 8


def onchip_smem_floats(n, k, blocks):
    """csrc/solve_fused.cu `onchip_smem_floats`: the block's whole 32-wide
    panels of A' with column stride n + 1, a copy of a peer's panel (two
    blocks a system), du and dv, four k·n vectors, ipiv, 16 reduction
    slots and 4 more."""
    panels = -(-n // 32)
    cols = 32 * -(-panels // blocks)
    return (cols * (n + 1) + (32 * (n + 1) if blocks > 1 else 0) + 4 * n
            + 4 * k * n + n + 16 + 4)


def fused_variant(n, k):
    """csrc/solve_fused.cu `solve_variant`: the on-chip variants for even
    96 <= N <= 256, the cluster of two only for k <= 4."""
    if n % 2 or not 96 <= n <= 256 or not 1 <= k <= 8:
        return 0
    if 4 * onchip_smem_floats(n, k, 1) <= MAX_SMEM:
        return 1
    if k <= 4 and 4 * onchip_smem_floats(n, k, 2) <= MAX_SMEM:
        return 2
    return 0


def nopivot_smem_floats(m, nb):
    """csrc/lu_nopivot.cu `nopivot_smem_floats`: the panel with column
    stride m + 1 and the staged pivot row."""
    return nb * (m + 1) + nb


def nopivot_variant(m, nb):
    """csrc/lu_nopivot.cu `nopivot_variant`."""
    if nb in (32, 64) and m <= 256:
        return 1 if nb == 32 else 2
    return 0


@pytest.mark.parametrize("n", [2, 16, 62, 64, 94, 96, 98, 100, 128, 192,
                               200, 224, 226, 256, 258, 512, 574, 576, 794,
                               796])
def test_solve_fused_mirrors_match_the_c_formulas(n):
    for k in range(1, 10):
        assert sf.smem_bytes(n, k) == 4 * fused_smem_floats(n, k)
        fits = (n % 2 == 0 and 1 <= k <= 8
                and 4 * fused_smem_floats(n, k) <= MAX_SMEM)
        assert sf.fits(n, k) == fits
        assert sf.variant(n, k) == fused_variant(n, k)
        # an on-chip variant only takes shapes the device-memory one does
        assert fused_variant(n, k) == 0 or fits
        for blocks in (1, 2):
            assert sf.onchip_smem_bytes(n, k, blocks) == \
                4 * onchip_smem_floats(n, k, blocks)


@pytest.mark.parametrize("shape,variant", [
    ((64, 1), 0), ((64, 8), 0), ((94, 1), 0), ((96, 1), 1), ((100, 2), 1),
    ((200, 1), 1), ((224, 1), 1), ((224, 8), 0), ((226, 2), 2),
    ((256, 1), 2), ((256, 4), 2), ((256, 8), 0), ((512, 1), 0),
    ((794, 1), 0), ((63, 1), 0)])
def test_solve_fused_variant_of_the_paths_shapes(shape, variant):
    """solve-256 (the main path) takes the cluster; N = 64 and the
    cluster's k > 4, where the on-chip variants lost to variant 0 on the
    card, keep variant 0."""
    assert sf.variant(*shape) == variant


def test_solve_fused_reach_is_unchanged():
    """Even N to 794 at k = 1 and to 574 at k = 8, as before the on-chip
    variants, and the routes built on it."""
    assert sf.fits(794, 1) and not sf.fits(796, 1)
    assert sf.fits(574, 8) and not sf.fits(576, 8)
    assert all(sf.fits(n, 1) for n in range(2, 795, 2))
    assert not any(sf.fits(n, 1) for n in range(1, 795, 2))
    assert dispatch._resolve("auto", 256, 1, True) == "rbt"
    assert dispatch._resolve("auto", 576, 8, False) == "rbt"


@pytest.mark.parametrize("nb", [2, 4, 8, 16, 32, 48, 64])
def test_lu_nopivot_mirrors_match_the_c_formulas(nb):
    for m in (nb, 40, 96, 224, 256, 257, 512, 896, 906, 907, 1016, 2048):
        if m < nb:
            continue
        assert lu_nopivot.smem_bytes(m, nb) == 4 * nopivot_smem_floats(m, nb)
        fits = 4 * nopivot_smem_floats(m, nb) <= MAX_SMEM
        assert lu_nopivot.fits(m, nb) == fits
        assert lu_nopivot.variant(m, nb) == nopivot_variant(m, nb)
        assert nopivot_variant(m, nb) == 0 or fits


@pytest.mark.parametrize("shape,variant", [
    ((256, 32), 1), ((32, 32), 1), ((224, 32), 1), ((256, 64), 2),
    ((64, 64), 2), ((896, 64), 0), ((40, 8), 0), ((257, 64), 0)])
def test_lu_nopivot_variant_of_the_paths_shapes(shape, variant):
    """solve-256-k16's panels (nb = 32, 256 down to 32 rows), inverse-256's
    (nb = 64, 256 down to 64) and reach-896's."""
    assert lu_nopivot.fits(*shape)
    assert lu_nopivot.variant(*shape) == variant


def test_lu_nopivot_reach_is_unchanged():
    assert lu_nopivot.fits(906, 64) and not lu_nopivot.fits(907, 64)


def test_the_one_hot_rule_shows_on_non_finite_panels():
    """Without the one-hot read, a NaN or an Inf below the square part
    leaves every pivot finite; with it both panels are flagged.  A clean
    panel factors the same."""
    g = torch.Generator().manual_seed(5)
    p = torch.randn(3, 40, 8, generator=g)
    p[:, torch.arange(8), torch.arange(8)] += 6.0
    p[1, 30, 1] = float("nan")
    p[2, 39, 2] = float("inf")
    x, ok = lu_nopivot.panel_factor_nopivot_reference(p, 8)
    y, ok0 = lu_nopivot.panel_factor_nopivot_reference(p, 8, one_hot=False)
    assert ok.tolist() == [True, False, False]
    assert ok0.tolist() == [True, True, True]
    assert torch.equal(x[0], y[0])
    assert x[1].isnan().sum() > y[1].isnan().sum()


# csrc/inv_rbt.cu INV_VARIANTS: (warps, rows a lane, slots a warp)
INV_VARIANTS = {1: (4, 1, 8), 2: (8, 2, 8), 3: (16, 4, 8), 4: (16, 6, 12)}


def inv_smem_floats(n, nw):
    """csrc/inv_rbt.cu `inv_smem_floats`: the tile with column stride
    n | 1 (or level 3's 10 n + 2 nw slots if more), two coefficient
    buffers and four diagonal pairs [2][n], the probe and X v, nw
    block-max slots and the zero-pivot flag."""
    return max(n * (n | 1), 10 * n + 2 * nw) + 12 * n + nw + 1


def inv_takes(v, n):
    nw, rows, slots = INV_VARIANTS[v]
    return n <= 32 * rows and n <= nw * slots


def inv_variant(n):
    """csrc/inv_rbt.cu `inv_variant`: the smallest tile that holds n."""
    if n <= 32:
        return 1
    if n <= 64:
        return 2
    if n <= 128:
        return 3
    return 4


@pytest.mark.parametrize("n", range(4, 181, 4))
def test_inv_rbt_mirrors_match_the_c_formulas(n):
    assert inv_rbt.fits(n)
    assert inv_rbt.variant(n) == inv_variant(n)
    assert inv_rbt.smem_bytes(n) == 4 * inv_smem_floats(
        n, INV_VARIANTS[inv_variant(n)][0])
    assert inv_rbt.takes(inv_rbt.variant(n), n)
    for v, (nw, _, _) in INV_VARIANTS.items():
        assert inv_rbt.takes(v, n) == inv_takes(v, n)
        assert inv_rbt.smem_bytes(n, v) == 4 * inv_smem_floats(n, nw)
        assert 4 * inv_smem_floats(n, nw) <= MAX_SMEM


@pytest.mark.parametrize("n,variant", [
    (16, 1), (32, 1), (36, 2), (64, 2), (68, 3), (128, 3), (132, 4),
    (164, 4), (172, 4), (180, 4)])
def test_inv_rbt_variant_of_the_paths_shapes(n, variant):
    """inverse-64 (metric 2), kernel 2's large shapes and the reach."""
    assert inv_rbt.variant(n) == variant


def test_inv_rbt_launch_refuses_what_the_kernel_does_not_take():
    """The checks before any build: N past the reach, a variant that does
    not take N."""
    a = torch.zeros(1, 184, 184)
    d = torch.zeros(2, 184)
    with pytest.raises(ValueError, match="from 4 to 180"):
        inv_rbt._launch(a, (d, d), (d, d), torch.zeros(184), True, None)
    a, d = torch.zeros(1, 96, 96), torch.zeros(2, 96)
    with pytest.raises(ValueError, match="variant 2 does not take N=96"):
        inv_rbt._launch(a, (d, d), (d, d), torch.zeros(96), True, 2)
