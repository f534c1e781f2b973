"""The complex elimination kernel's register variant leaves the rows in
place and keeps each row's position; ``kernels.complex_gauss.
gauss_rows_in_place_reference`` is that schedule written plainly.  Here
it is held to the bit (NaN-equal, flags included) against the plain
version ``gauss_pivots_complex_reference``, which exchanges rows by
gathers, on the CPU: entries from {0, ±1, ±i, ±1 ± i} so that magnitudes
tie after exchanges, a zero column (``ok`` False), NaN and Inf entries,
n = 1, 2, 33 and 64 in f32 and f64; and the Python mirror of the variant
choice and its reach."""

import numpy as np
import pytest
import torch

from linalg_solver_tpu_torch.ops.kernels import complex_gauss as cg


def _nan_equal(x, y):
    return bool(((x == y) | (x.isnan() & y.isnan())).all())


def _tied_lanes(B, n, seed, dtype):
    """Lanes of entries from {0, ±1, ±i, ±1 ± i}: lane 1 with a zero first
    column, lane 2 a NaN, lane 3 an Inf, lane 4 a zero column halfway."""
    rng = np.random.RandomState(seed)
    re = rng.randint(-1, 2, (B, n, n)).astype(np.float64)
    im = rng.randint(-1, 2, (B, n, n)).astype(np.float64)
    re[1, :, 0] = im[1, :, 0] = 0.0
    if n > 2:
        re[2, n // 2, 1] = np.nan
        im[3, 0, n - 1] = np.inf
        re[4, :, n // 2] = im[4, :, n // 2] = 0.0
    return (torch.from_numpy(re).to(dtype), torch.from_numpy(im).to(dtype))


@pytest.mark.parametrize("n", [1, 2, 33, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_in_place_matches_plain(n, dtype):
    re, im = _tied_lanes(6, n, n, dtype)
    want = cg.gauss_pivots_complex_reference(re, im)
    got = cg.gauss_rows_in_place_reference(re, im)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _nan_equal(g, w)
    assert not bool(got[3][1])
    if n > 2:
        assert not bool(got[3][4])
        # rows were exchanged: the plain version moved them, the model
        # moved positions, and both took the same pivots
        assert bool((got[2] == -1).any())


def test_rows_in_place_on_gaussian_lanes():
    """Distinct magnitudes, a scaled lane and exchanges at most steps."""
    rng = np.random.RandomState(7)
    re = torch.from_numpy(rng.randn(4, 48, 48).astype(np.float32))
    im = torch.from_numpy(rng.randn(4, 48, 48).astype(np.float32))
    re[2] *= 1e-3
    im[2] *= 1e-3
    want = cg.gauss_pivots_complex_reference(re, im)
    got = cg.gauss_rows_in_place_reference(re, im)
    for g, w in zip(got, want):
        assert _nan_equal(g, w)
    assert bool(got[3].all())


def test_variant_mirror_and_reach():
    f32, f64 = torch.float32, torch.float64
    # the register variant to n = 192 in f32 and 128 in f64, device memory
    # past it; every n of the register variant within a block's shared
    # memory
    assert [cg.variant(n, f32) for n in (1, 128, 170, 171, 192, 193)] == [
        2, 2, 2, 2, 2, 1]
    assert [cg.variant(n, f64) for n in (1, 96, 120, 128, 129)] == [
        2, 2, 2, 2, 1]
    for dtype, reach in ((f32, 192), (f64, 128)):
        for n in range(1, reach + 1):
            assert 0 < cg.smem_bytes(n, dtype) <= cg.SMEM_LIMIT
        assert cg.smem_bytes(reach + 1, dtype) == 0
        for R, (cr, cs) in cg.REGS_SLOTS[dtype].items():
            assert cr + cs == 2 * R      # 2R column slots a warp of 16
    assert cg.smem_bytes(192, f32) == (16 * 8 * 2 * 192 + 4 * 192
                                       + 32 * 193) * 4 + 64
    assert cg.scratch_ld(192) == 193 and cg.scratch_ld(193) == 193
    assert cg.fits(1000, f32) and not cg.fits(0, f32)
