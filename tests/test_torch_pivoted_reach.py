"""The reach and variant choice of the pivoted kernels (Gauss–Jordan,
``ops/kernels/gauss_jordan``, and the masked panel LU,
``ops/kernels/lu_panel``), on the CPU.

Both wrappers choose a kernel variant by shape alone, and their
``smem_bytes`` / ``fits`` / ``variant`` mirror C formulas in
``csrc/gauss_jordan.cu``, ``csrc/gj_pivot.cuh`` and ``csrc/lu_panel.cu``.
The formulas are written out here once more, so that a change on either
side shows; the routes that follow from the reach (the inverse to
N = 167, and with kernel 2 at N % 4 = 0 to 180, det and rank to N = 237,
the phase loop's 64-wide panels) are checked as numbers, and the big
reach of the rank and the affine solve against the reference's own
``gj_kernel.supported`` with its big VMEM budget.
"""

import pytest

from linalg_solver_tpu.ops.pallas import gj_kernel as jgj
from linalg_solver_tpu_torch.ops import lu_blocked
from linalg_solver_tpu_torch.ops import kernels
from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
from linalg_solver_tpu_torch.ops.kernels import lu_panel

MAX_SMEM = 232448  # bytes of shared memory a block may take on sm_90


def gj_smem_floats(n, w):
    """csrc/gj_pivot.cuh: the [n, w | 1] tile, prow [w], nfc [2][w],
    coeff, pivoted, perm and pivs [n] each, the argmax slots [2][8]."""
    return n * (w | 1) + 3 * w + 4 * n + 2 * 8


def gj_variant(n, w):
    """csrc/gauss_jordan.cu `gj_variant`: rows lane + 32 i (i < R),
    columns warp + NW k (k < C), (NW, R, C) = (8, 2, 16) and (32, 4, 8);
    then shared memory (0) where the tile fits a block, device memory (3)
    within the big reach n * ceil8(w) <= 180,224, else none (-1)."""
    if n <= 32 * 2 and w <= 8 * 16:
        return 1
    if n <= 32 * 4 and w <= 32 * 8:
        return 2
    if not 1 <= n <= w:
        return -1
    if 4 * gj_smem_floats(n, w) <= MAX_SMEM:
        return 0
    if n * ((w + 7) // 8 * 8) <= 180224:
        return 3
    return -1


def panel_smem_floats(n, nb):
    """csrc/lu_panel.cu: the panel with column stride n + 1, prow [nb],
    nfc [2][nb], state [n], the argmax slots [2][8]."""
    return nb * (n + 1) + 3 * nb + n + 2 * 8


def panel_variant(n, nb):
    """csrc/lu_panel.cu `panel_variant`."""
    if nb == 32:
        return 1 if n <= 1024 else 0
    if nb == 64:
        return 2 if n <= 256 else 0
    return 0


@pytest.mark.parametrize("n", [1, 8, 33, 63, 64, 65, 100, 127, 128, 129,
                               164, 167, 168, 200, 236, 237, 238, 241])
def test_gauss_jordan_mirrors_match_the_c_formulas(n):
    for w in sorted({n, n + 1, 2 * n, 128, 129, 256, 257, 334}):
        assert gj.smem_bytes(n, w) == 4 * gj_smem_floats(n, w)
        fits = n <= w and 4 * gj_smem_floats(n, w) <= MAX_SMEM
        assert gj.fits(n, w) == fits
        assert gj.variant(n, w) == gj_variant(n, w)
        # the shared-memory variant has eight rows a thread of 32 warps
        assert not fits or gj.variant(n, w) != 0 or n <= 256


@pytest.mark.parametrize("nb", [2, 4, 8, 16, 32, 48, 64])
def test_lu_panel_mirrors_match_the_c_formulas(nb):
    for n in (nb, 96, 256, 257, 512, 513, 889, 890, 960, 1024, 1025, 1756,
              1757, 2048):
        if n < nb:
            continue
        assert lu_panel.smem_bytes(n, nb) == 4 * panel_smem_floats(n, nb)
        fits = 4 * panel_smem_floats(n, nb) <= MAX_SMEM
        assert lu_panel.fits(n, nb) == fits
        assert lu_panel.variant(n, nb) == panel_variant(n, nb)
        # a register variant only takes shapes the shared-memory one does
        assert panel_variant(n, nb) == 0 or fits


@pytest.mark.parametrize("shape,variant", [
    ((64, 128), 1), ((63, 126), 1), ((63, 63), 1), ((127, 254), 2),
    ((100, 101), 2), ((167, 334), 0), ((237, 237), 0), ((236, 237), 0)])
def test_gauss_jordan_variant_of_the_paths_shapes(shape, variant):
    assert gj.fits(*shape)
    assert gj.variant(*shape) == variant


@pytest.mark.parametrize("shape,variant", [
    ((256, 64), 2), ((512, 64), 0), ((889, 64), 0), ((960, 32), 1),
    ((96, 32), 1), ((1024, 32), 1), ((16, 4), 0), ((256, 48), 0)])
def test_lu_panel_variant_of_the_paths_shapes(shape, variant):
    assert lu_panel.fits(*shape)
    assert lu_panel.variant(*shape) == variant


def test_pivoted_facade_reach():
    """The inverse to N = 167 (kernel 3), and on to 180 at N % 4 = 0
    (kernel 2, the reference's reach); det to 237, solve to 236: the same
    N as before the register variants, and not one more.  The rank to
    424, the reference's big budget (variant 3 past 237)."""
    assert all(kernels.supports("inverse", n) for n in range(1, 168))
    assert all(kernels.supports("inverse", n) for n in range(168, 181, 4))
    assert all(kernels.supports("det", n) for n in range(1, 238))
    assert all(kernels.supports("rank", n) for n in range(1, 425))
    assert all(kernels.supports("solve", n) for n in range(1, 237))
    assert not any(kernels.supports("inverse", n)
                   for n in (169, 170, 171, 181, 184))
    assert not kernels.supports("det", 238)
    assert not kernels.supports("rank", 425)
    assert not kernels.supports("solve", 237)


@pytest.mark.parametrize("n", range(64, 1024, 64))
def test_panel_split_keeps_one_level_where_it_did(n):
    """nb = 64 in one level up to N = 889 (every N % 64 = 0 to 832), two
    levels of 32-wide sub-panels at 896 and 960."""
    want = None if n <= 889 else 32
    assert lu_blocked.panel_split(n, 64) == want
    inner = 64 if want is None else want
    assert lu_panel.fits(n, inner)


def test_reach_960_takes_the_register_variant():
    nbi = lu_blocked.panel_split(960, 64)
    assert nbi == 32
    assert lu_panel.variant(960, nbi) == 1


@pytest.mark.parametrize("lo", range(200, 431, 50))
def test_fits_big_mirrors_the_reference_big_budget(lo):
    """``fits_big`` against the reference's ``gj_kernel.supported(n, w,
    VMEM_TILE_BUDGET_BIG)`` for n = 200 … 430 at the rank's [n, n] and
    the affine solve's [n, n + 1]; ``variant`` is 3 exactly where
    ``fits`` fails and ``fits_big`` holds."""
    for n in range(lo, min(lo + 50, 431)):
        for w in (n, n + 1):
            want = jgj.supported(n, w, budget=jgj.VMEM_TILE_BUDGET_BIG)
            assert gj.fits_big(n, w) == want, (n, w)
            v3 = not gj.fits(n, w) and gj.fits_big(n, w)
            assert (gj.variant(n, w) == 3) == v3, (n, w)
            assert gj.variant(n, w) == gj_variant(n, w), (n, w)


def test_big_reach_ends_where_the_reference_does():
    assert gj.fits_big(424, 424) and not gj.fits_big(425, 425)
    assert gj.fits_big(423, 424) and not gj.fits_big(424, 425)
    assert gj.variant(237, 237) == 0 and gj.variant(238, 238) == 3
    assert gj.variant(236, 237) == 0 and gj.variant(237, 238) == 3
    assert gj.variant(256, 257) == 3 and gj.variant(425, 425) == -1
