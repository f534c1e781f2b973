"""Kernel 3's variant 3, the tile in a thread-block cluster's shared
memory (``csrc/gauss_jordan.cu`` ``gj_cluster_kernel``), on the CPU: its
C formulas written out once more, and the routes that follow from them.

Variant 3 takes every ``[n, w]`` array past ``fits`` (one block's shared
memory) within ``fits_big`` (the reference's big VMEM budget).  A block
of its cluster holds every C-th column at the odd stride ``n | 1`` with
two coefficient buffers, the columns' non-finite counts and two slots;
C is the least of 2, 4 and 8 whose share fits 232,448 bytes.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import pytest

from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj

MAX_SMEM = 232448      # bytes of shared memory a block may take on sm_90
BIG_ELEMS = 180224     # the reference's big budget over 128 lanes of 4 B


def gj_cluster_floats(n, w, c):
    """csrc/gauss_jordan.cu `gj_cluster_floats`: ceil(w / c) columns of
    n | 1 floats, coeff [2][n], the columns' counts, slots [2][2]."""
    cmax = (w + c - 1) // c
    return cmax * (n | 1) + 2 * n + cmax + 4


def cluster_size_of(n, w):
    """csrc/gauss_jordan.cu `cluster_size_of`."""
    for c in (2, 4, 8):
        if 4 * gj_cluster_floats(n, w, c) <= MAX_SMEM:
            return c
    return 0


def fits_big(n, w):
    return 1 <= n <= w and n * ((w + 7) // 8 * 8) <= BIG_ELEMS


def parent_variant(n, w):
    """The variant before the cluster (the device-memory tile): 3 on
    everything past ``fits`` within ``fits_big``."""
    if n <= 64 and w <= 128:
        return 1
    if n <= 128 and w <= 256:
        return 2
    if gj.fits(n, w):
        return 0
    return 3 if fits_big(n, w) else -1


def widest(n):
    """The largest w that ``fits_big`` takes at n."""
    return BIG_ELEMS // n // 8 * 8


#: the square and affine n that variant 3 takes: from the first past
#: ``fits`` to the last of ``fits_big``
FIRST = next(n for n in range(1, 500) if not gj.fits(n, n + 1))
LAST = max(n for n in range(1, 500) if fits_big(n, n))


def test_the_square_and_affine_reach_of_variant_3():
    assert (FIRST, LAST) == (237, 424)
    assert gj.variant(236, 237) == 0 and gj.variant(237, 238) == 3
    assert gj.variant(237, 237) == 0 and gj.variant(238, 238) == 3
    assert gj.variant(424, 424) == 3 and gj.variant(425, 425) == -1
    assert gj.variant(423, 424) == 3 and gj.variant(424, 425) == -1


@pytest.mark.parametrize("lo", range(FIRST, LAST + 1, 47))
def test_cluster_mirrors_match_the_c_formulas(lo):
    """Bytes a block, cluster size and variant for every n from the
    first past ``fits`` to the last of ``fits_big``, at w = n (the rank)
    and w = n + 1 (the affine solve)."""
    for n in range(lo, min(lo + 47, LAST + 1)):
        for w in (n, n + 1):
            c = cluster_size_of(n, w)
            assert gj.cluster_size(n, w) == c, (n, w)
            for k in (2, 4, 8):
                assert (gj.cluster_smem_bytes(n, w, k)
                        == 4 * gj_cluster_floats(n, w, k))
            assert gj.variant(n, w) == parent_variant(n, w), (n, w)
            if gj.variant(n, w) == 3:
                # two blocks to n = 337, four past that; a block's
                # share fits, and n <= 32 * 14 rows a lane
                assert c == (2 if n <= 337 else 4) and n <= 448
                assert 4 * gj_cluster_floats(n, w, c) <= MAX_SMEM


def test_the_paths_shapes_take_clusters_of_two_and_four():
    assert gj.cluster_size(256, 257) == 2      # affine, Jordan, core
    assert gj.cluster_size(424, 424) == 4      # rank-424
    assert gj.cluster_size(423, 424) == 4
    assert gj.cluster_smem_bytes(256, 257, 2) == 4 * (129 * 257 + 512
                                                      + 129 + 4)
    # the last block holds one column fewer where w is odd
    assert -(-257 // 2) == 129 and (257 - 1 + 1) // 2 == 128


@pytest.mark.parametrize("lo", range(1, LAST + 1, 53))
def test_variant_3_routes_no_shape_differently_from_the_parent(lo):
    """Every ``fits_big`` shape past ``fits`` still takes variant 3: at
    every n its widest w has a cluster whose block share fits (the share
    grows with w), and the variant equals the parent's at the square, the
    affine, the widest and one past the widest array."""
    for n in range(lo, min(lo + 53, LAST + 1)):
        wide = widest(n)
        assert fits_big(n, wide) and not fits_big(n, wide + 8)
        assert cluster_size_of(n, wide) > 0, n
        for w in {n, n + 1, 2 * n, 257, 1024, wide, wide + 1, wide + 8}:
            if w >= n:
                assert gj.variant(n, w) == parent_variant(n, w), (n, w)


def test_the_narrowest_tiles_need_eight_blocks():
    """The widest arrays of the smallest n (to w = 180,224 at n = 1) need
    a cluster of 8: the counts add a float a column beside its n | 1."""
    assert gj.variant(1, widest(1)) == 3
    assert cluster_size_of(1, widest(1)) == 8
    assert cluster_size_of(4, widest(4)) == 8
    assert cluster_size_of(16, widest(16)) == 4
