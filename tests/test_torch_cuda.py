"""The port's CUDA kernels on a card, against their plain PyTorch
versions.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import importlib

import numpy as np
import pytest
import torch

from linalg_solver_tpu_torch.ops import dispatch, rbt
from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot, lu_panel
from linalg_solver_tpu_torch.ops.kernels import gauss_jordan as gj
from linalg_solver_tpu_torch.ops.kernels import inv_rbt
from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf
from linalg_solver_tpu_torch.utils import systems

# The solve kernel's panel-blocked LU and FMA contraction round
# differently from the plain version's rank-1 updates, and its on-chip
# variants solve through the diagonal blocks' inverses; all refine to the
# solution of a well-conditioned system, so they agree to a few f32
# roundings of it (≤ 7.8e-7 measured on an H100).  The inverse kernels run
# the plain versions' operations in the same order and agree to the bit
# or within a rounding (≤ 3.7e-9 relative measured on an H100): the
# probe's sums run in another order, and the plain version rounds its
# fused multiply-adds twice.
# The phase engine's two kernels (butterfly, no-pivot panel) and the
# masked pivoted panel kernel run the plain versions' operations in the
# same order and agree to the bit.
# 1e-5 relative is the bound chip_smoke.py holds all of them to; the
# unrefined solution of the small-pivot probe system misses it by
# ~1000x, and the inverse without its rescue misses the flags.
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(B, N, seed, k=None, dev="cpu"):
    rng = np.random.RandomState(seed)
    a = (rng.randn(B, N, N) + 4.0 * np.sqrt(N) * np.eye(N)).astype(
        np.float32)
    shape = (B, N) if k is None else (B, N, k)
    b = rng.randn(*shape).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def _probe(a, U, V):
    """Systems 2 (zero) and 5 (NaN) flagged; 6 with a zero leading minor
    (flagged only without the butterfly); 7 with a SMALL_PIVOT first
    pivot after the butterfly (off by ≥ 2e-3 without refinement)."""
    a[2] = 0.0
    a[5, 3, 7] = float("nan")
    a[6] = systems.zero_minor_system(a[6])
    a[7] = systems.pivot_system(a[7], U, V, systems.SMALL_PIVOT)
    return a


def _worst_rel(x, bad, x_ref, bad_ref):
    """Worst relative difference of x over the unflagged systems; the
    flags and the non-finite pattern must agree exactly."""
    assert torch.equal(bad.cpu(), bad_ref.cpu())
    x, x_ref, bad = x.cpu().double(), x_ref.cpu().double(), bad.cpu()
    fin = torch.isfinite(x)
    assert torch.equal(fin, torch.isfinite(x_ref))
    worst = 0.0
    for i in range(x.shape[0]):
        if not bad[i]:
            err = (x[i] - x_ref[i]).abs().max() / x_ref[i].abs().max()
            worst = max(worst, float(err))
    return worst


def _assert_agree(x, bad, x_ref, bad_ref):
    assert _worst_rel(x, bad, x_ref, bad_ref) <= RTOL


def _resid(a, b, x):
    b3 = b.reshape(b.shape[0], b.shape[1], -1).double()
    r = a.double() @ x.reshape(b3.shape).double() - b3
    return r.abs().amax(dim=(1, 2)) / b3.abs().amax(dim=(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N,k", [(64, 1), (64, 8), (100, 2), (98, 1), (256, 1), (256, 8),
            (226, 2), (512, 1)]
)
def test_kernel_matches_plain_version(cuda, N, k):
    """The probe systems ride along (``_probe``); 2 and 5 are flagged."""
    a, b = _batch(8, N, seed=N + k, k=k, dev=cuda)
    U, V = rbt.default_diags(N, rbt.MAIN_SEEDS, str(cuda))
    a = _probe(a, U, V)
    before = sf.LAUNCHES
    x, bad = sf.solve_fused_rbt(a, b, U, V)
    torch.cuda.synchronize()
    assert sf.LAUNCHES == before + 1
    x_ref, bad_ref = sf.solve_fused_rbt_reference(a, b, U, V)
    _assert_agree(x, bad, x_ref, bad_ref)
    assert bad.cpu().tolist() == [i in (2, 5) for i in range(8)]
    keep = [0, 1, 3, 4, 6, 7]
    assert float(_resid(a, b, x)[keep].max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ir_steps", [0, 1, 3])
def test_kernel_ir_steps(cuda, ir_steps):
    a, b = _batch(4, 64, seed=ir_steps, dev=cuda)
    U, V = rbt.default_diags(64, rbt.MAIN_SEEDS, str(cuda))
    x, bad = sf.solve_fused_rbt(a, b, U, V, ir_steps=ir_steps)
    x_ref, bad_ref = sf.solve_fused_rbt_reference(a, b, U, V, ir_steps)
    _assert_agree(x, bad, x_ref, bad_ref)


@pytest.mark.cuda
def test_kernel_check_sees_missing_refinement(cuda):
    """The comparison above fails for the kernel run without refinement:
    the values of its small-pivot system 7 are off by far more than
    RTOL, whether or not the loose unrefined gate also flags it."""
    a, b = _batch(8, 64, seed=65, dev=cuda)
    U, V = rbt.default_diags(64, rbt.MAIN_SEEDS, str(cuda))
    a = _probe(a, U, V)
    x0, _ = sf.solve_fused_rbt(a, b, U, V, ir_steps=0)
    x_ref, bad_ref = sf.solve_fused_rbt_reference(a, b, U, V)
    assert not bool(bad_ref[7])
    err = (x0[7] - x_ref[7]).abs().max() / x_ref[7].abs().max()
    assert float(err) > 10 * RTOL


@pytest.mark.cuda
def test_smem_mirror_matches_the_kernel(cuda):
    from linalg_solver_tpu_torch.ops.kernels import _build

    lib = _build.load()
    for n in (2, 16, 64, 98, 100, 224, 226, 256, 258, 574, 576, 794, 796,
              1024):
        for k in (1, 2, 8):
            assert lib.solve_fused_smem_bytes(n, k) == sf.smem_bytes(n, k)
            assert lib.solve_variant(n, k) == sf.variant(n, k)


@pytest.mark.cuda
def test_kernel_variants_run_where_they_are_chosen(cuda):
    """The shapes of the test above reach every variant: 1 (one block a
    system: N = 98, 100), 2 (a cluster of two: N = 226, 256 at k <= 4) and
    0 (the device-memory scratch: N = 64, 512, and 256 at k = 8); each
    reports its resources."""
    shapes = [(64, 1), (64, 8), (100, 2), (98, 1), (256, 1), (256, 8),
              (226, 2), (512, 1)]
    assert {sf.variant(n, k) for n, k in shapes} == {0, 1, 2}
    for n, k in ((100, 2), (256, 1), (512, 1)):
        attr = sf.attributes(n, k)
        assert attr["registers"] > 0 and attr["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    a, b = _batch(2, 64, seed=0, dev=cuda)
    U, V = rbt.default_diags(64, rbt.MAIN_SEEDS, str(cuda))
    with pytest.raises(ValueError, match="diags_u"):
        sf.solve_fused_rbt(a, b, U[:1], V)
    with pytest.raises(ValueError, match="is on"):
        sf.solve_fused_rbt(a, b, U.cpu(), V)
    with pytest.raises(ValueError, match="shared memory"):
        big, bb = _batch(1, 1024, seed=0, k=8, dev=cuda)
        U2, V2 = rbt.default_diags(1024, rbt.MAIN_SEEDS, str(cuda))
        sf.solve_fused_rbt(big, bb, U2, V2)


@pytest.mark.cuda
def test_main_path_launches_the_kernel_and_rescues(cuda):
    """3 has a zero leading minor, 7 is singular, 11 meets a zero pivot
    under the main draw and is left to the redraw; the rest come back
    bitwise as in a clean call."""
    a, b = _batch(16, 256, seed=8, dev=cuda)
    x_clean = dispatch.solve_batched(a, b)
    a[3, :16, :16] = 0.0
    a[7] = 0.0
    U, V = rbt.default_diags(256, rbt.MAIN_SEEDS, str(cuda))
    a[11] = systems.pivot_system(a[11], U, V, 0.0)
    sf.LAUNCHES = 0
    x = dispatch.solve_batched(a, b)
    torch.cuda.synchronize()
    assert sf.LAUNCHES == 2   # main launch + one rescue launch
    r = _resid(a, b, x)
    keep = [i for i in range(16) if i != 7]
    assert float(r[keep].max()) <= 1e-5
    assert not bool(torch.isfinite(x[7]).all())
    for i in range(16):
        if i not in (3, 7, 11):
            assert torch.equal(x[i], x_clean[i]), i


@pytest.mark.cuda
def test_main_path_gradient(cuda):
    a, b = _batch(4, 64, seed=9, k=3, dev=cuda)
    w = torch.randn(b.shape, generator=torch.Generator().manual_seed(1))
    grads = []
    for solve in (dispatch.solve_batched, torch.linalg.solve):
        at, bt = a.clone().requires_grad_(), b.clone().requires_grad_()
        (solve(at, bt) * w.to(cuda)).sum().backward()
        grads.append((at.grad, bt.grad))
    for got, want in zip(*grads):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def _inverse_probe(B, n, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(B, n, n, generator=g, device=dev)
    a += 4.0 * n**0.5 * torch.eye(n, device=dev)
    draw = rbt.default_diags(n, rbt.MAIN_SEEDS, str(dev))
    redraw = rbt.default_diags(n, rbt.RESCUE_SEEDS, str(dev))
    return systems.inverse_probe_batch(a, draw, redraw), draw, redraw


def _rel_per_matrix(x, x_ref):
    d = (x - x_ref).abs().amax(dim=(1, 2))
    return d / x_ref.abs().amax(dim=(1, 2)).clamp_min(1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(8, 32), (8, 64), (8, 128), (8, 164),
                                 (1024, 64), (8, 172), (8, 180)])
@pytest.mark.parametrize("rescue", [True, False])
def test_inverse_kernel_matches_plain_version(cuda, B, n, rescue):
    a, draw, redraw = _inverse_probe(B, n, n + B, cuda)
    probe = rbt.default_probe(n, str(cuda))
    before = inv_rbt.LAUNCHES
    x, bad = inv_rbt.inverse_rbt_fused(a, draw, redraw, probe, rescue)
    torch.cuda.synchronize()
    assert inv_rbt.LAUNCHES == before + 1
    x_ref, bad_ref = inv_rbt.inverse_rbt_fused_reference(
        a, draw, redraw, probe, rescue)
    assert torch.equal(bad, bad_ref)
    want = systems.INVERSE_FLAGGED if rescue else [1, 2, 4, 5, 6]
    assert bad.nonzero().flatten().tolist() == want
    assert torch.equal(torch.isfinite(x), torch.isfinite(x_ref))
    use = ~bad
    use[6] = rescue          # level 3: flagged, but its X is right
    assert float(_rel_per_matrix(x, x_ref)[use].max()) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("v,n", [(1, 8), (1, 32), (2, 60), (2, 64),
                                 (3, 100), (3, 128), (4, 64), (4, 132),
                                 (4, 180)])
def test_inverse_kernel_variants_match_plain_version(cuda, v, n):
    """Each variant, chosen by name, on the probe batch (level 3 on
    matrix 6), against the plain version; with its resources."""
    a, draw, redraw = _inverse_probe(8, n, 7 * n + v, cuda)
    probe = rbt.default_probe(n, str(cuda))
    x, bad = inv_rbt.inverse_rbt_fused(a, draw, redraw, probe, v=v)
    torch.cuda.synchronize()
    x_ref, bad_ref = inv_rbt.inverse_rbt_fused_reference(
        a, draw, redraw, probe)
    assert bad.nonzero().flatten().tolist() == systems.INVERSE_FLAGGED
    assert torch.equal(bad, bad_ref)
    assert torch.equal(torch.isfinite(x), torch.isfinite(x_ref))
    use = ~bad
    use[6] = True
    assert float(_rel_per_matrix(x, x_ref)[use].max()) <= RTOL
    attr = inv_rbt.attributes(n, v)
    assert attr["registers"] > 0 and attr["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_inverse_check_sees_a_missing_rescue(cuda):
    """The kernel without levels 2 and 3 fails the comparison with the
    full plain version: its flags differ."""
    a, draw, redraw = _inverse_probe(8, 64, 3, cuda)
    probe = rbt.default_probe(64, str(cuda))
    _, bad = inv_rbt.inverse_rbt_fused(a, draw, redraw, probe, rescue=False)
    _, bad_ref = inv_rbt.inverse_rbt_fused_reference(a, draw, redraw, probe)
    assert not torch.equal(bad, bad_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(8, 9), (33, 66), (63, 126), (64, 128),
                                 (100, 101), (167, 334), (236, 236),
                                 (127, 254), (237, 237)])
def test_gauss_jordan_kernel_matches_plain_version(cuda, n, w):
    g = torch.Generator(device=cuda).manual_seed(n + w)
    a = torch.randn(6, n, w, generator=g, device=cuda)
    a[1, :, 0] = 0.0                       # a skipped column
    a[2, 3, 5] = float("nan")
    a[3] = 0.0
    tol = torch.tensor([0.0, 0.0, 0.0, 0.0, 1e-2, 3.0], device=cuda)
    before = gj.LAUNCHES
    r = gj.gauss_jordan_tiled(a, tol)
    torch.cuda.synchronize()
    assert gj.LAUNCHES == before + 1
    p = gj.gauss_jordan_reference(a, tol)
    assert torch.equal(r.perm, p.perm)
    fin = torch.isfinite(r.reduced)
    assert torch.equal(fin, torch.isfinite(p.reduced))
    for i in range(6):
        if fin[i].all():
            err = (r.reduced[i] - p.reduced[i]).abs().max()
            assert float(err) <= RTOL * float(p.reduced[i].abs().max()), i
    torch.testing.assert_close(r.pivots, p.pivots, rtol=RTOL, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(256, 257), (424, 424), (423, 424)])
def test_gauss_jordan_device_memory_variant_is_bitwise(cuda, n, w):
    """Variant 3 (the big reach; the tile in a cluster's shared memory,
    once in device memory): perm, the reduced array and
    the pivots equal to the plain version's, bit for bit, on full-rank,
    rank-deficient (a repeated and a zero row, a zero column: a skipped
    step) lanes, a lane with an Inf and one with a NaN in the last
    column, with a threshold (tol > 0) and without."""
    assert gj.variant(n, w) == 3
    g = torch.Generator(device=cuda).manual_seed(n + w)
    a = torch.randn(8, n, w, generator=g, device=cuda)
    a[1, 5] = a[1, 2]
    a[2, :, 3] = 0.0
    a[3, 9] = 0.0
    a[5, 7, 11] = float("inf")
    a[6, n - 3, w - 1] = float("nan")
    tol = torch.full((8,), 1e-4, device=cuda)
    tol[4] = 0.0
    before = gj.LAUNCHES
    r = gj.gauss_jordan_tiled(a, tol)
    torch.cuda.synchronize()
    assert gj.LAUNCHES == before + 1
    p = gj.gauss_jordan_reference(a, tol)
    assert torch.equal(r.perm, p.perm)
    assert _nan_equal(r.reduced, p.reduced) and _nan_equal(r.pivots, p.pivots)
    assert (r.pivots != 0).sum(dim=1).tolist()[:4] == [n, n - 1, n - 1, n - 1]
    # the Inf spreads through its lane, the NaN stays a NaN
    assert not bool(torch.isfinite(r.reduced[5]).all())
    assert bool(r.reduced[6].isnan().any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,c", [(300, 301, 2), (129, 600, 2),
                                   (20, 8000, 4), (4, 45056, 8)])
def test_gauss_jordan_cluster_sizes_are_bitwise(cuda, n, w, c):
    """Variant 3 in each of its cluster sizes and row counts a lane (14
    past n = 256), bitwise against the plain version with a skipped
    column, an Inf and a NaN lane, and its C formulas against the
    Python mirrors; the card holds at least one such cluster."""
    from linalg_solver_tpu_torch.ops.kernels import _build

    lib = _build.load()
    assert gj.variant(n, w) == 3 and gj.cluster_size(n, w) == c
    assert lib.gj_cluster_size(n, w) == c
    assert lib.gj_cluster_smem_bytes(n, w) == gj.cluster_smem_bytes(n, w, c)
    assert lib.gj_clusters(n, w) > 0
    g = torch.Generator(device=cuda).manual_seed(n + w)
    a = torch.randn(4, n, w, generator=g, device=cuda)
    a[1, :, 0] = 0.0
    a[2, n // 2, w // 2] = float("inf")
    a[3, n - 1, w - 1] = float("nan")
    tol = torch.tensor([0.0, 1e-3, 0.0, 0.0], device=cuda)
    r = gj.gauss_jordan_tiled(a, tol)
    torch.cuda.synchronize()
    p = gj.gauss_jordan_reference(a, tol)
    assert torch.equal(r.perm, p.perm)
    assert _nan_equal(r.reduced, p.reduced) and _nan_equal(r.pivots, p.pivots)


@pytest.mark.cuda
def test_gauss_jordan_cluster_mirrors_match_the_kernel(cuda):
    from linalg_solver_tpu_torch.ops.kernels import _build

    lib = _build.load()
    for n in range(200, 431):
        for w in (n, n + 1, 2 * n, 180224 // n // 8 * 8):
            assert lib.gj_cluster_size(n, w) == gj.cluster_size(n, w)
            assert lib.gj_variant(n, w) == gj.variant(n, w)


@pytest.mark.cuda
def test_affine_and_rank_paths_launch_variant_3_once(cuda):
    """``affine_solve_batched(auto)`` at N = 256 and ``rank_batched(auto)``
    at N = 300: one launch of kernel 3 each (variant 3), consistent
    lanes solved, ranks those constructed."""
    solve = importlib.import_module("linalg_solver_tpu_torch.ops.solve")

    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(4, 256, 256, generator=g, device=cuda)
    a[1, :, 7] = a[1, :, 3]
    b = torch.randn(4, 256, generator=g, device=cuda)
    b[1] = a[1] @ torch.randn(256, generator=g, device=cuda)
    before = gj.LAUNCHES
    res = dispatch.affine_solve_batched(a, b)
    torch.cuda.synchronize()
    assert gj.LAUNCHES == before + 1
    assert res.dim.tolist() == [0, 1, 0, 0] and res.is_consistent.all()
    r = (a.double() @ res.particular.double()[..., None])[..., 0] - b
    assert float(r.abs().max() / b.abs().max()) <= 1e-4
    want = solve.solve_affine_gj_batched(a.cpu(), b.cpu())
    assert torch.equal(res.dim.cpu(), want.dim)
    low = torch.randn(4, 300, 40, generator=g, device=cuda) @ torch.randn(
        4, 40, 300, generator=g, device=cuda)
    before = gj.LAUNCHES
    assert dispatch.rank_batched(low).tolist() == [40] * 4
    assert gj.LAUNCHES == before + 1


@pytest.mark.cuda
def test_inverse_smem_mirrors_match_the_kernels(cuda):
    from linalg_solver_tpu_torch.ops.kernels import _build

    lib = _build.load()
    for n in range(1, 250):
        for w in (n, n + 1, 2 * n):
            assert lib.gj_smem_bytes(n, w) == gj.smem_bytes(n, w)
    for n in range(4, 200, 4):
        assert lib.inv_rbt_smem_bytes(n) == inv_rbt.smem_bytes(n)
        assert lib.inv_variant(n) == inv_rbt.variant(n)
        for v in inv_rbt.VARIANTS:
            assert lib.inv_variant_smem(v, n) == inv_rbt.smem_bytes(n, v)
    for n in range(1, 431):
        for w in (n, n + 1, 2 * n, 128, 256, 257):
            assert lib.gj_variant(n, w) == gj.variant(n, w)
    # past the shared-memory reach variant 3 takes [238, 238]; past the
    # big reach too, the kernel refuses
    assert gj.variant(238, 238) == 3
    with pytest.raises(ValueError, match="shared memory"):
        gj.gauss_jordan_tiled(torch.zeros(1, 425, 425, device=cuda))


@pytest.mark.cuda
def test_inverse_main_path_launches_kernel_2_once(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(256, 64, 64, generator=g, device=cuda)
    a += 32.0 * torch.eye(64, device=cuda)
    x_clean = dispatch.inverse_batched(a)
    a[3, :16, :16] = 0.0
    a[7] = 0.0
    draw = rbt.default_diags(64, rbt.MAIN_SEEDS, str(cuda))
    redraw = rbt.default_diags(64, rbt.RESCUE_SEEDS, str(cuda))
    a[11] = systems.two_draw_zero_pivot_system(a[11], draw, redraw)
    counts = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    x = dispatch.inverse_batched(a)
    torch.cuda.synchronize()
    assert (inv_rbt.LAUNCHES, gj.LAUNCHES) == (counts[0] + 1, counts[1])
    eye = torch.eye(64, device=cuda, dtype=torch.float64)
    r = (a.double() @ x.double() - eye).abs().amax(dim=(1, 2))
    keep = [i for i in range(256) if i not in (3, 7, 11)]
    assert float(r[keep].max()) <= 5e-5
    assert float(r[3]) <= 1e-2 and float(r[11]) <= 1e-5
    for i in keep:
        assert torch.equal(x[i], x_clean[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("n", [172, 180])
def test_inverse_auto_to_180_launches_kernel_2_once(cuda, n):
    """Past an [n, 2n] tile's shared memory, as the reference does: one
    kernel-2 launch, a float64 residual of 5e-5."""
    g = torch.Generator(device=cuda).manual_seed(n)
    a = torch.randn(16, n, n, generator=g, device=cuda)
    a += 4.0 * n**0.5 * torch.eye(n, device=cuda)
    counts = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    x = dispatch.inverse_batched(a)
    torch.cuda.synchronize()
    assert (inv_rbt.LAUNCHES, gj.LAUNCHES) == (counts[0] + 1, counts[1])
    eye = torch.eye(n, device=cuda, dtype=torch.float64)
    assert float((a.double() @ x.double() - eye).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_pivoted_facade_on_the_card(cuda):
    """N = 63 is not a multiple of 4: the inverse goes to kernel 3, as do
    det and rank."""
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(16, 63, 63, generator=g, device=cuda)
    a += 4.0 * 63**0.5 * torch.eye(63, device=cuda)
    counts = (inv_rbt.LAUNCHES, gj.LAUNCHES)
    x = dispatch.inverse_batched(a)
    torch.cuda.synchronize()
    assert (inv_rbt.LAUNCHES, gj.LAUNCHES) == (counts[0], counts[1] + 1)
    eye = torch.eye(63, device=cuda, dtype=torch.float64)
    assert float((a.double() @ x.double() - eye).abs().max()) <= 5e-5
    s = torch.eye(63, device=cuda) + 0.1 * torch.randn(
        16, 63, 63, generator=g, device=cuda) / 63**0.5
    d = dispatch.det_batched(s)
    torch.testing.assert_close(d.double(), torch.linalg.det(s.double()),
                               rtol=1e-4, atol=0)
    low = s[:, :, :5] @ s[:, :5, :]
    assert dispatch.rank_batched(low).tolist() == [5] * 16


@pytest.mark.cuda
def test_inverse_and_det_gradients(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.eye(32, device=cuda) + 0.2 * torch.randn(
        4, 32, 32, generator=g, device=cuda)
    w = torch.randn(4, 32, 32, generator=g, device=cuda)
    for ours, lib in ((dispatch.inverse_batched, torch.linalg.inv),
                      (dispatch.det_batched, torch.linalg.det)):
        grads = []
        for fn in (ours, lib):
            at = a.clone().requires_grad_()
            out = fn(at)
            (out * (w if out.dim() == 3 else w[:, 0, 0])).sum().backward()
            grads.append(at.grad)
        err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
        assert float(err) <= 1e-4


# --- the RBT phase engine: kernels 4 (butterfly) and 5 (no-pivot panel) --


def _nan_equal(x, y):
    """Bitwise equal, NaN where the other is NaN."""
    return bool(((x == y) | (x.isnan() & y.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,depth", [(64, 1), (64, 2), (98, 1), (256, 1),
                                     (256, 2), (896, 1), (896, 2)])
@pytest.mark.parametrize("trans", [(True, True), (False, False),
                                   (True, False)])
def test_butterfly_kernel_matches_plain_version_bitwise(cuda, n, depth,
                                                        trans):
    g = torch.Generator(device=cuda).manual_seed(n + depth)
    a = torch.randn(3, n, n, generator=g, device=cuda)
    a[1, 2, 3] = float("inf")
    U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, str(cuda))
    before = butterfly.LAUNCHES
    x = butterfly.butterfly_two_sided(a, U, V, depth, *trans)
    torch.cuda.synchronize()
    assert butterfly.LAUNCHES == before + 1
    assert _nan_equal(
        x, butterfly.butterfly_two_sided_reference(a, U, V, depth, *trans))


@pytest.mark.cuda
def test_butterfly_check_sees_a_flipped_side(cuda):
    a = torch.randn(2, 64, 64, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    U, V = rbt.default_diags(64, rbt.MAIN_SEEDS, str(cuda))
    ref = butterfly.butterfly_two_sided_reference(a, U, V, 2, True, True)
    for trans in ((False, True), (True, False), (False, False)):
        x = butterfly.butterfly_two_sided(a, U, V, 2, *trans)
        assert float((x - ref).abs().max()) > 1e-2


def _probe_panels(m, nb, dev):
    """0 clean, 1 a zero pivot, 2 a NaN reaching a pivot, 3 an Inf in the
    last row, 4 a NaN pivot, 5 clean."""
    g = torch.Generator(device=dev).manual_seed(m + nb)
    p = torch.randn(6, m, nb, generator=g, device=dev)
    p[:, torch.arange(nb), torch.arange(nb)] += 4.0 * nb**0.5
    p[1, :, 3] = 0.0
    p[2, 5, 1] = float("nan")
    p[3, m - 1, 2] = float("inf")
    p[4, 2, 2] = float("nan")
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("m,nb", [(8, 8), (40, 8), (64, 16), (256, 32),
                                  (224, 32), (32, 32), (256, 64), (64, 64),
                                  (896, 64), (1016, 8)])
def test_lu_nopivot_kernel_matches_plain_version(cuda, m, nb):
    """Equal flags and values equal to the bit, NaN where the plain
    version's is NaN, in every variant (register variants 1 and 2 at
    nb = 32 and 64 up to m = 256, the shared-memory one elsewhere)."""
    p = _probe_panels(m, nb, cuda)
    before = lu_nopivot.LAUNCHES
    x, ok = lu_nopivot.panel_factor_nopivot(p, nb)
    torch.cuda.synchronize()
    assert lu_nopivot.LAUNCHES == before + 1
    x_ref, ok_ref = lu_nopivot.panel_factor_nopivot_reference(p, nb)
    assert torch.equal(ok, ok_ref)
    assert ok.tolist() == [True, False, False, False, False, True]
    assert _nan_equal(x, x_ref)


@pytest.mark.cuda
def test_lu_nopivot_check_sees_a_dropped_one_hot_rule(cuda):
    """The bitwise check above fails against a plain version that reads
    its pivots directly (no one-hot rule), in each register variant: the
    probe panels' non-finite entries below a pivot decide it."""
    for m, nb in ((256, 32), (256, 64)):
        p = _probe_panels(m, nb, cuda)
        x, ok = lu_nopivot.panel_factor_nopivot(p, nb)
        y, ok0 = lu_nopivot.panel_factor_nopivot_reference(p, nb,
                                                           one_hot=False)
        assert not (_nan_equal(x, y) and torch.equal(ok, ok0))


@pytest.mark.cuda
def test_phase_kernels_smem_mirror_and_reach(cuda):
    from linalg_solver_tpu_torch.ops.kernels import _build

    lib = _build.load()
    for m in (8, 33, 224, 256, 257, 896, 906, 907, 1016, 2048):
        for nb in (8, 16, 32, 48, 64):
            assert lib.nopivot_smem_bytes(m, nb) == lu_nopivot.smem_bytes(
                m, nb)
            assert lib.nopivot_variant(m, nb) == lu_nopivot.variant(m, nb)
    for m, nb in ((256, 32), (256, 64), (896, 64)):
        attr = lu_nopivot.attributes(m, nb)
        assert attr["registers"] > 0 and attr["blocks_per_sm"] >= 1
    with pytest.raises(ValueError, match="shared memory"):
        lu_nopivot.panel_factor_nopivot(
            torch.zeros(1, 907, 64, device=cuda), 64)
    with pytest.raises(RuntimeError, match="CUDA error"):
        # the kernel itself refuses a depth its wrapper would not pass
        butterfly._launch(torch.zeros(1, 8, 8, device=cuda),
                          torch.ones(3, 8, device=cuda),
                          torch.ones(3, 8, device=cuda), 3, True, True)


def _counts():
    return (sf.LAUNCHES, butterfly.LAUNCHES, lu_nopivot.LAUNCHES)


@pytest.mark.cuda
def test_phase_solve_path_on_the_card(cuda):
    """k = 16 > 8: one butterfly launch, N/32 panel launches, no fused
    one; the rescue cases of the fused path hold here too."""
    a, b = _batch(16, 256, seed=10, k=16, dev=cuda)
    c0 = _counts()
    x_clean = dispatch.solve_batched(a, b)
    torch.cuda.synchronize()
    assert tuple(x - y for x, y in zip(_counts(), c0)) == (0, 1, 8)
    assert float(_resid(a, b, x_clean).max()) <= 1e-5
    a[3] = systems.zero_minor_system(a[3])
    a[7] = 0.0
    U, V = rbt.default_diags(256, rbt.MAIN_SEEDS, str(cuda))
    a[11] = systems.pivot_system(a[11], U, V, 0.0)
    x = dispatch.solve_batched(a, b)
    torch.cuda.synchronize()
    r = _resid(a, b, x)
    keep = [i for i in range(16) if i != 7]
    assert float(r[keep].max()) <= 1e-5
    assert not bool(torch.isfinite(x[7]).all())
    for i in range(16):
        if i not in (3, 7, 11):
            assert torch.equal(x[i], x_clean[i]), i


@pytest.mark.cuda
def test_phase_solve_matches_the_plain_path(cuda):
    """The phase engine on the card against the same engine on the CPU
    (the plain versions) with f32 glue: equal flags, values within RTOL;
    without refinement the small-pivot system 7 misses by far more."""
    n, k = 64, 16
    a, b = _batch(8, n, seed=12, k=k, dev=cuda)
    U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, str(cuda))
    a = _probe(a, U, V)
    cpu = (U.cpu(), V.cpu())
    x, bad = rbt._solve_core(a, b, (U, V), 16, 2, "float32")
    x_ref, bad_ref = rbt._solve_core(a.cpu(), b.cpu(), cpu, 16, 2, "float32")
    assert bad.cpu().tolist() == [i in (2, 5) for i in range(8)]
    _assert_agree(x, bad, x_ref, bad_ref)
    x0, _ = rbt._solve_core(a, b, (U, V), 16, 0, "float32")
    err = (x0[7].cpu() - x_ref[7]).abs().max() / x_ref[7].abs().max()
    assert float(err) > 10 * RTOL


@pytest.mark.cuda
def test_phase_inverse_path_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    n = 256
    a = torch.randn(8, n, n, generator=g, device=cuda)
    a += 4.0 * n**0.5 * torch.eye(n, device=cuda)
    c0 = (inv_rbt.LAUNCHES, gj.LAUNCHES) + _counts()[1:]
    x = dispatch.inverse_batched(a)
    torch.cuda.synchronize()
    c1 = (inv_rbt.LAUNCHES, gj.LAUNCHES) + _counts()[1:]
    assert tuple(p - q for p, q in zip(c1, c0)) == (0, 0, 2, 4)
    eye = torch.eye(n, device=cuda, dtype=torch.float64)
    assert float((a.double() @ x.double() - eye).abs().max()) <= 5e-5
    # det with a gradient at 168 takes the phase inverse in its backward
    s = (torch.eye(168, device=cuda) + 0.1 * torch.randn(
        2, 168, 168, generator=g, device=cuda) / 168**0.5)
    grads = []
    for det in (dispatch.det_batched, torch.linalg.det):
        st = s.clone().requires_grad_()
        det(st).sum().backward()
        grads.append(st.grad)
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(err) <= 1e-4


# --- kernel 6 (masked partial-pivot panel) and the paths that run it ----


def _masked_panels(B, n, nb, frac, dev):
    """Gaussian panels with about ``frac`` of the rows pre-pivoted (an int
    ``frac``: exactly that many); panel 0 has a zero column 1, panel 1 a
    NaN at (5, 2), and panel 3 an Inf in its first pre-pivoted row."""
    g = torch.Generator(device=dev).manual_seed(n + nb)
    p = torch.randn(B, n, nb, generator=g, device=dev)
    if isinstance(frac, int):
        order = torch.rand(B, n, generator=g, device=dev).argsort(dim=1)
        m = (order < frac).to(torch.int32)
    else:
        m = (torch.rand(B, n, generator=g, device=dev) < frac).to(torch.int32)
    p[0, :, 1] = 0.0
    p[1, 5, 2] = float("nan")
    pre = m[3].nonzero().flatten()
    if B > 3 and len(pre):
        p[3, int(pre[0]), nb // 2] = float("inf")
    return p, m


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,nb,frac", [(8, 16, 4, 0.3), (16, 96, 32, 0.4),
                                         (32, 256, 64, 0.0),
                                         (32, 256, 64, 0.4),
                                         (4, 889, 64, 0.2),
                                         (4, 960, 32, 0.3),
                                         # each variant (lu_panel.VARIANTS)
                                         (32, 256, 64, 64),
                                         (32, 256, 64, 128),
                                         (32, 256, 64, 192),
                                         (8, 1024, 32, 300),
                                         (4, 600, 64, 0.3)])
def test_lu_panel_kernel_matches_plain_version_bitwise(cuda, B, n, nb, frac):
    """All five outputs equal to the bit (NaN where the other is NaN),
    the zero-column, NaN and Inf-in-a-pre-pivoted-row panels included, in
    every variant."""
    p, m = _masked_panels(B, n, nb, frac, cuda)
    before = lu_panel.LAUNCHES
    out = lu_panel.panel_factor_masked(p, m, nb)
    torch.cuda.synchronize()
    assert lu_panel.LAUNCHES == before + 1
    ref = lu_panel.panel_factor_masked_reference(p, m, nb)
    for x, y in zip(out, ref):
        assert x.dtype == y.dtype and _nan_equal(x, y)
    assert out[4][:3].tolist() == [False, False, True]


@pytest.mark.cuda
def test_lu_panel_check_sees_a_dropped_mask(cuda):
    p, m = _masked_panels(8, 64, 16, 0.4, cuda)
    out = lu_panel.panel_factor_masked(p, torch.zeros_like(m), 16)
    ref = lu_panel.panel_factor_masked_reference(p, m, 16)
    assert not torch.equal(out[1], ref[1])


@pytest.mark.cuda
def test_lu_panel_smem_mirror_and_reach(cuda):
    from linalg_solver_tpu_torch.ops.kernels import _build

    lib = _build.load()
    for n in (1, 16, 256, 257, 512, 513, 889, 890, 960, 1024, 1025, 1756,
              2048):
        for nb in (2, 4, 16, 32, 48, 64):
            assert lib.panel_smem_bytes(n, nb) == lu_panel.smem_bytes(n, nb)
            assert lib.panel_variant(n, nb) == lu_panel.variant(n, nb)
    with pytest.raises(ValueError, match="shared memory"):
        lu_panel.panel_factor_masked(torch.zeros(1, 890, 64, device=cuda),
                                     torch.zeros(1, 890, device=cuda), 64)


def _panel_count():
    return lu_panel.LAUNCHES


@pytest.mark.cuda
def test_mixed_det_and_lu_factor_paths_on_the_card(cuda):
    """B = 16, N = 256, nb = 64: four kernel-6 launches a call."""
    a, b = _batch(16, 256, seed=30, dev=cuda)
    c0 = _panel_count()
    x = dispatch.solve_batched(a, b, backend="mixed")
    torch.cuda.synchronize()
    assert _panel_count() - c0 == 4
    assert float(_resid(a, b, x).max()) <= 1e-5
    g = torch.Generator(device=cuda).manual_seed(31)
    s = torch.eye(256, device=cuda) + torch.randn(
        16, 256, 256, generator=g, device=cuda) / 32.0
    c0 = _panel_count()
    d = dispatch.det_batched(s)
    torch.cuda.synchronize()
    assert _panel_count() - c0 == 4
    want = torch.linalg.det(s.double().cpu())
    assert float(((d.double().cpu() - want) / want).abs().max()) <= 1e-3
    c0 = _panel_count()
    res = dispatch.lu_factor_batched(a)
    torch.cuda.synchronize()
    assert _panel_count() - c0 == 4
    lu = res.lu.double()
    lo = torch.tril(lu, -1) + torch.eye(256, device=cuda, dtype=torch.float64)
    pa = a.double().gather(1, res.perm.long()[:, :, None].expand(-1, -1, 256))
    err = (lo @ torch.triu(lu) - pa).abs().amax()
    assert float(err) <= 1e-5 * float(a.abs().max())


@pytest.mark.cuda
def test_large_solve_on_the_card(cuda):
    """N = 1024: one butterfly launch, no panel kernel."""
    a, b = _batch(2, 1024, seed=32, dev=cuda)
    c0 = (butterfly.LAUNCHES, _panel_count())
    x = dispatch.solve_batched(a, b)
    torch.cuda.synchronize()
    assert (butterfly.LAUNCHES - c0[0], _panel_count() - c0[1]) == (1, 0)
    assert float(_resid(a, b, x).max()) <= 1e-5


@pytest.mark.cuda
def test_blocked_pallas_backends_on_the_card(cuda):
    """The solve, inverse and det of ``backend="blocked_pallas"`` at
    N = 128 (nb = 64: two kernel-6 launches each), and det with a
    gradient at N = 256, whose backward takes the phase inverse."""
    a, b = _batch(8, 128, seed=33, k=3, dev=cuda)
    c0 = _panel_count()
    x = dispatch.solve_batched(a, b, backend="blocked_pallas")
    xi = dispatch.inverse_batched(a, backend="blocked_pallas")
    torch.cuda.synchronize()
    assert _panel_count() - c0 == 4
    assert float(_resid(a, b, x).max()) <= 1e-5
    eye = torch.eye(128, device=cuda, dtype=torch.float64)
    assert float((a.double() @ xi.double() - eye).abs().max()) <= 5e-5
    g = torch.Generator(device=cuda).manual_seed(34)
    s = torch.eye(256, device=cuda) + torch.randn(
        2, 256, 256, generator=g, device=cuda) / 32.0
    grads = []
    for det in (dispatch.det_batched, torch.linalg.det):
        st = s.clone().requires_grad_()
        det(st).sum().backward()
        grads.append(st.grad)
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(err) <= 1e-4


@pytest.mark.cuda
def test_auto_routes_the_reference_serves_on_the_card(cuda):
    """Odd N takes kernel 3 on ``[A | b]`` (one launch, as
    ``ops.kernels.solve_batched``); from N = 1024 the solve at
    N % 128 != 0, the inverse and the det take ``torch.linalg``, with no
    kernel launch."""
    from linalg_solver_tpu_torch.ops import kernels

    a, b = _batch(16, 63, seed=35, dev=cuda)
    c0 = (gj.LAUNCHES, sf.LAUNCHES)
    x = dispatch.solve_batched(a, b)
    torch.cuda.synchronize()
    assert (gj.LAUNCHES - c0[0], sf.LAUNCHES - c0[1]) == (1, 0)
    assert torch.equal(x, kernels.solve_batched(a, b))
    assert float(_resid(a, b, x).max()) <= 1e-5
    a, b = _batch(1, 1088, seed=36, dev=cuda)
    counts = (gj.LAUNCHES, sf.LAUNCHES, butterfly.LAUNCHES,
              lu_panel.LAUNCHES)
    x = dispatch.solve_batched(a, b)
    assert torch.equal(x, torch.linalg.solve(a, b[:, :, None])[:, :, 0])
    a = a[:, :1024, :1024].contiguous()
    assert torch.equal(dispatch.inverse_batched(a), torch.linalg.inv(a))
    assert torch.equal(dispatch.det_batched(a), torch.linalg.det(a))
    torch.cuda.synchronize()
    assert (gj.LAUNCHES, sf.LAUNCHES, butterfly.LAUNCHES,
            lu_panel.LAUNCHES) == counts


@pytest.mark.cuda
def test_jordan_analysis_gj_on_the_card_matches_the_cpu(cuda):
    """``jordan_analysis(method="gj")`` at n = 256 (kernel 3's variant 3,
    one launch a deflation step) gives the Weyr characteristic the CPU
    port (its plain version) gives, and the built one."""
    from linalg_solver_tpu_torch.models.jordan import jordan_analysis
    from linalg_solver_tpu_torch.ops.generate import jordan_batch

    blocks = ((2.0, 3),) * 20 + ((2.0, 2),) * 20 + ((5.0, 2),) * 40 + (
        (1.0, 1),) * 76
    a = jordan_batch(torch.Generator(device=cuda).manual_seed(1), 2, blocks,
                     transform="orthogonal", device=cuda)
    before = gj.LAUNCHES
    rep = jordan_analysis(a, (2.0, 5.0, 1.0), k_max=4, method="gj")
    torch.cuda.synchronize()
    assert gj.LAUNCHES - before == 4
    cpu = jordan_analysis(a.cpu(), (2.0, 5.0, 1.0), k_max=4, method="gj")
    for got, want in zip(rep, cpu):
        assert torch.equal(got.cpu(), want)
    assert rep.weyr[0].tolist() == [[40, 40, 20, 0], [40, 40, 0, 0],
                                    [76, 0, 0, 0]]


# --- the real Schur solver: the chase kernel and the outer sweep ---------


def _schur_state(B, n, dev, with_q, dtype=torch.float32, seed=0):
    from linalg_solver_tpu_torch.ops import schur

    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(B, n, n, generator=g, device=dev, dtype=dtype)
    H, Q, hi, st, an, _ = schur._schur_init(a, with_q=with_q)
    return a, (H, Q, hi, st, an, torch.zeros_like(hi, dtype=torch.bool),
               torch.zeros((), dtype=torch.long, device=dev))


def _record_sweep(state, npairs=8, aed_w=32):
    """Run one outer sweep from ``state``; return the arguments and
    results of every window and chase launch in it."""
    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw

    wins, chases = [], []
    ow, oc = sw.window_schur, sc.francis_chase

    def rw(*args):
        out = ow(*args)
        wins.append(([a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args], out))
        return out

    def rc(H, Q, tables, nc):
        args = (H.clone(), None if Q is None else Q.clone(),
                [t.clone() for t in tables], nc)
        out = oc(H, Q, tables, nc)
        chases.append((args, out))
        return out

    sw.window_schur, sc.francis_chase = rw, rc
    try:
        with schur.f32_matmuls():
            schur._schur_sweep(state, npairs, aed_w)
    finally:
        sw.window_schur, sc.francis_chase = ow, oc
    torch.cuda.synchronize()
    return wins, chases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_chase_kernel_matches_plain_version(cuda, dtype):
    """The chase of one outer sweep at [32, 256, 256] (the main multishift
    sweep's, with Q; the AED windows go to the window kernel) against the
    plain version on the same input, bitwise in both variants: both round
    every operation on its own in the same order."""
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc

    _, state = _schur_state(32, 256, cuda, True, dtype)
    _, calls = _record_sweep(state)
    assert [c[0][0].shape[1] for c in calls] == [257]
    (H, Q, tables, nc), (Ho, Qo) = calls[0]
    Hr, Qr = sc.francis_chase_reference(H, Q, tables, nc)
    assert torch.equal(Ho, Hr) and torch.equal(Qo, Qr)
    assert sc.variant(256, dtype) == 1
    out = sc.francis_chase(H, Q, tables, nc, v=0)
    assert torch.equal(out[0], Hr) and torch.equal(out[1], Qr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_chase_cluster_variant_without_q(cuda, dtype):
    """The cluster variant (H in the shared memory of a cluster of blocks)
    and the device-memory variant on the main chase without Q, bitwise
    the plain version."""
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc

    _, state = _schur_state(32, 256, cuda, False, dtype, seed=1)
    _, calls = _record_sweep(state)
    H, Q, tables, nc = calls[0][0]
    assert Q is None and nc == 7
    Hr, _ = sc.francis_chase_reference(H, Q, tables, nc)
    for v in sc.VARIANTS:
        assert torch.equal(sc.francis_chase(H, Q, tables, nc, v=v)[0], Hr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_window_kernel_matches_plain_version(cuda, dtype):
    """The window kernel on the AED round of one outer sweep at [32, 256,
    256] (its one launch), and on the same windows with lanes converged
    on entry (hw 0 and -1) and a NaN lane, bitwise (NaN-equal) its plain
    version: H, Q, hw and the trailing deflation's rows and end."""
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw

    _, state = _schur_state(32, 256, cuda, False, dtype)
    before = sw.LAUNCHES
    wins, _ = _record_sweep(state)
    assert len(wins) == 1 and sw.LAUNCHES == before + 1
    (Hw, Qw, hw, an, *rest), out = wins[0]
    assert tuple(Hw.shape) == (32, 33, 33) and len(out) == 5
    Hn, hn = Hw.clone(), hw.clone()
    Hn[0, 3, 5] = float("nan")
    hn[1], hn[2] = 0, -1
    nan_args = (Hn, Qw, hn, an, *rest)
    for args, got in (((Hw, Qw, hw, an, *rest), out),
                      (nan_args, sw.window_schur(*nan_args))):
        want = sw.window_schur_reference(*args)
        for g, w in zip(got, want):
            assert _nan_equal(g, w)
    assert bool(torch.isnan(got[0][0]).any()) and int(got[2][0]) >= 1
    assert bool((got[3] > 0).any())


@pytest.mark.cuda
def test_schur_kernel_mirrors_match_their_c_formulas(cuda):
    """The Python mirrors of the chase's variant rule and cluster shape and
    of the window kernel's shared memory agree with the C entry points."""
    from linalg_solver_tpu_torch.ops.kernels import _build
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw

    lib = _build.load()
    for dtype, f64 in ((torch.float32, 0), (torch.float64, 1)):
        for n in (2, 32, 64, 127, 128, 256, 300, 400, 500, 600):
            assert lib.chase_variant(n, f64) == sc.variant(n, dtype), n
            cs = lib.chase_cluster_size(n, f64)
            assert cs == sc.cluster_size(n, dtype), n
            if cs:
                assert lib.chase_cluster_smem_bytes(n, f64) == \
                    sc.cluster_smem_bytes(n, cs, dtype)
        for w in (1, 8, 32, 64, 100, 118, 119, 127, 128):
            want = sw.smem_bytes(w, dtype) if sw.fits(w, dtype) else 0
            assert lib.schur_window_smem_bytes(w, f64) == want, (w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("with_q", [False, True])
def test_schur_outer_sweep_reads_nothing_back(cuda, with_q):
    """One outer sweep at [32, 256, 256] (an AED round: one window-kernel
    launch of up to 64 inner sweeps; then the 276-step multishift chase)
    runs under ``set_sync_debug_mode("error")``, eagerly and as a CUDA-graph
    replay: no host read inside it; the replay gives the eager sweep's
    state."""
    from linalg_solver_tpu_torch.ops import schur

    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw

    _, state = _schur_state(32, 256, cuda, with_q)
    before = sw.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        with schur.f32_matmuls():
            eager = schur._schur_sweep(state, 8, 32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sw.LAUNCHES == before + 1
    g = schur._sweep_graph(state, 8, 32)
    assert g.launches == (1, 1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for got, want in zip(g.state, eager):
        if want is not None:
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_eigvals_schur_on_the_card(cuda):
    """``eigvals_schur`` on the card: in f32 at n = 128 every lane
    converged and clean, the eigenvalues within 2e-3 of numpy's float64
    ones; in float64 at n = 48 every lane converged, and the lanes the
    stall breaker left alone within 1e-9·‖A‖ (below n = 96 there is no
    AED, and in float64 the reference's single double shift force-splits
    most Gaussian lanes too: 6 of 8 on this input, run through the JAX
    package on a CPU)."""
    from linalg_solver_tpu_torch.ops.schur import eigvals_schur

    for n, dtype in ((128, torch.float32), (48, torch.float64)):
        g = torch.Generator(device=cuda).manual_seed(n)
        a = torch.randn(8, n, n, generator=g, device=cuda, dtype=dtype)
        res = eigvals_schur(a)
        assert bool(res.converged.all())
        if dtype == torch.float32:
            assert bool(res.clean.all())
        want = np.linalg.eigvals(a.double().cpu().numpy())
        got = torch.complex(res.real.double(),
                            res.imag.double()).cpu().numpy()
        limit = (2e-3 if dtype == torch.float32
                 else 1e-9 * float(a.abs().sum(2).amax()))
        for i in range(8):
            if not bool(res.clean[i]):
                continue
            left = list(want[i])
            for z in got[i]:
                j = int(np.argmin(np.abs(np.array(left) - z)))
                assert abs(left.pop(j) - z) <= limit


@pytest.mark.cuda
def test_cholesky_on_the_card_is_nan_where_it_fails(cuda):
    """``ops.spd`` on the card: an indefinite lane's factor is NaN in its
    lower triangle and not ``ok`` (``cholesky_ex`` leaves finite garbage
    there); the other lanes agree with the CPU's within 1e-5."""
    from linalg_solver_tpu_torch.ops import spd

    g = torch.Generator().manual_seed(5)
    x = torch.randn(8, 64, 64, generator=g)
    a = x @ x.mT + 64 * torch.eye(64)
    a[3] = -a[3]
    got = spd.cholesky_batched(a.to(cuda))
    want = spd.cholesky_batched(a)
    assert got.ok.cpu().tolist() == [True] * 3 + [False] + [True] * 4
    lower = torch.ones(64, 64, dtype=torch.bool).tril()
    assert got.L[3].isnan().cpu().equal(lower)
    ok = want.ok
    assert float((got.L.cpu()[ok] - want.L[ok]).abs().max()) <= (
        RTOL * float(want.L[ok].abs().max()))


@pytest.mark.cuda
def test_lstsq_on_the_card(cuda):
    """``ops.lstsq`` at the serving shape's ratio, [16, 768, 256] and its
    minimum-norm transpose: x within 1e-4 of the float64 solution, the
    lane with a zero column not ``ok`` and NaN."""
    from linalg_solver_tpu_torch.ops.lstsq import lstsq_batched

    g = torch.Generator(device=cuda).manual_seed(6)
    for m, n in ((768, 256), (256, 768)):
        a = torch.randn(16, m, n, generator=g, device=cuda)
        if m >= n:
            a[4, :, 7] = 0.0
        else:
            a[4, 7] = 0.0
        b = torch.randn(16, m, generator=g, device=cuda)
        res = lstsq_batched(a, b)
        assert res.ok.cpu().tolist() == [i != 4 for i in range(16)]
        assert bool(res.x[4].isnan().all())
        keep = res.ok
        want = torch.linalg.lstsq(a[keep].double(),
                                  b[keep].double()[..., None]).solution[..., 0]
        rel = (res.x[keep].double() - want).norm(dim=1) / want.norm(dim=1)
        assert float(rel.max()) <= 1e-4


@pytest.mark.cuda
def test_svd_on_the_card(cuda):
    """``ops.svd`` at [16, 256, 256]: σ within 1e-5·σmax of the float64
    ones, ‖UΣVᵀ − A‖/‖A‖ and ‖UᵀU − I‖ within 1e-5."""
    from linalg_solver_tpu_torch.ops.svd import svd_batched

    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(16, 256, 256, generator=g, device=cuda)
    res = svd_batched(a)
    assert bool(res.ok.all())
    s64 = torch.linalg.svdvals(a.double())
    assert float((res.s.double() - s64).abs().amax(1).max()
                 / s64[:, 0].max()) <= 1e-5
    U, s, V = res.U.double(), res.s.double(), res.V.double()
    back = (U * s[:, None, :]) @ V.mT
    assert float(((back - a.double()).norm(dim=(1, 2))
                  / a.double().norm(dim=(1, 2))).max()) <= 1e-5
    eye = torch.eye(256, dtype=torch.float64, device=cuda)
    assert float((U.mT @ U - eye).norm(dim=(1, 2)).max()) <= 1e-5


@pytest.mark.cuda
def test_rcond_on_the_card(cuda):
    """``ops.cond`` on the card agrees with the CPU's within 1e-5 (the
    same pivots), is 0 on a singular lane, and lies between the exact
    1/κ₁ and three times it."""
    from linalg_solver_tpu_torch.ops.cond import rcond_batched

    g = torch.Generator().manual_seed(8)
    n = 64
    a = torch.randn(8, n, n, generator=g) + 4 * n ** 0.5 * torch.eye(n)
    a[5, 9] = a[5, 3]
    got = rcond_batched(a.to(cuda)).cpu()
    want = rcond_batched(a)
    assert float(got[5]) == 0.0 == float(want[5])
    keep = torch.arange(8) != 5
    assert bool(((got[keep] - want[keep]).abs()
                 <= RTOL * want[keep]).all())
    a64 = a[keep].double()
    exact = 1 / (torch.linalg.matrix_norm(a64, 1)
                 * torch.linalg.matrix_norm(torch.linalg.inv(a64), 1))
    assert bool((got[keep] >= exact * (1 - 1e-4)).all())
    assert bool((got[keep] <= 3 * exact).all())


@pytest.mark.cuda
def test_det_exact_on_the_card_flags_the_overflow_lanes(cuda):
    """``ops.exact_int`` on the card: Bareiss gives the CPU's det, rank
    and ok bit for bit, the wrapped det of an overflowing lane included;
    ok is False there, and ``crt_det_batched`` on the card gives its exact
    determinant."""
    from linalg_solver_tpu_torch.ops import exact_int

    g = torch.Generator().manual_seed(9)
    a = torch.randint(-5, 5, (64, 8, 8), generator=g, dtype=torch.int32)
    a[7] *= 3000
    got = exact_int.bareiss_batched(a.to(cuda))
    want = exact_int.bareiss_batched(a)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    assert not bool(got.ok[7])
    dets = exact_int.crt_det_batched(a[[7]].to(cuda))
    assert dets == exact_int.crt_det_batched(a[[7]])
    import fractions
    m = [[fractions.Fraction(int(v)) for v in row] for row in a[7]]
    det = fractions.Fraction(1)
    for j in range(8):
        p = next(i for i in range(j, 8) if m[i][j] != 0)
        if p != j:
            m[j], m[p], det = m[p], m[j], -det
        det *= m[j][j]
        for i in range(j + 1, 8):
            f = m[i][j] / m[j][j]
            m[i] = [x - f * y for x, y in zip(m[i], m[j])]
    assert dets == [int(det)]


def _eigpairs(res):
    lam = (res.real.double() + 1j * res.imag.double()).cpu().numpy()
    V = (res.vectors_real.double()
         + 1j * res.vectors_imag.double()).cpu().numpy()
    return lam, V, res.valid.cpu().numpy()


@pytest.mark.cuda
def test_eig_batched_on_the_card(cuda):
    """``eig_batched`` at n = 128 on the card (both Schur kernels
    launched) against its own run on the CPU (the plain versions): the
    flags and the valid count of each lane equal; the eigenvalues, matched
    one to one with numpy's float64 ones, no farther from them than 1e-5
    of the lane's largest or 1.5x the CPU run's distance (the two Schur
    forms round differently, and an eigenvalue's rounding grows with its
    condition); the residual ``‖Av − λv‖ / ‖A‖_F`` of every valid column
    below 1e-5."""
    from scipy.optimize import linear_sum_assignment

    from linalg_solver_tpu_torch.ops import schur
    from linalg_solver_tpu_torch.ops.kernels import schur_chase as sc
    from linalg_solver_tpu_torch.ops.kernels import schur_window as sw

    a = torch.from_numpy(np.random.RandomState(0).randn(4, 128, 128)
                         .astype(np.float32))
    sc.LAUNCHES = sw.LAUNCHES = 0
    got = schur.eig_batched(a.to(cuda))
    torch.cuda.synchronize()
    assert sc.LAUNCHES >= 1 and sw.LAUNCHES >= 1
    want = schur.eig_batched(a)
    assert torch.equal(got.converged.cpu(), want.converged)
    assert torch.equal(got.valid.sum(1).cpu(), want.valid.sum(1))
    lg, Vg, vg = _eigpairs(got)
    lw, _, _ = _eigpairs(want)
    a64 = a.double().numpy()
    for b in range(4):
        true = np.linalg.eigvals(a64[b])
        dev = []
        for lam in (lg[b], lw[b]):
            r, c = linear_sum_assignment(np.abs(true[:, None] - lam[None]))
            dev.append(np.abs(true[r] - lam[c]).max())
        assert dev[0] <= max(1e-5 * np.abs(true).max(), 1.5 * dev[1])
        res = np.linalg.norm(a64[b] @ Vg[b] - Vg[b] * lg[b][None], axis=0)
        assert res[vg[b]].max() / np.linalg.norm(a64[b]) <= 1e-5


@pytest.mark.cuda
def test_shifted_backsolve_on_the_card(cuda):
    """The row loop on the card against the CPU within 1e-5 of the
    largest entry, at a rectangular right side."""
    from linalg_solver_tpu_torch.ops import schur

    rng = np.random.RandomState(2)
    sv = schur.real_schur_vectors(torch.from_numpy(
        rng.randn(3, 96, 96).astype(np.float32)))
    args = [sv.T] + [torch.from_numpy(rng.randn(*s).astype(np.float32))
                     for s in ((3, 40), (3, 40), (3, 96, 40), (3, 96, 40))]
    want = schur._shifted_backsolve(*args)
    got = schur._shifted_backsolve(*(t.to(cuda) for t in args))
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
def test_matrix_equations_on_the_card(cuda):
    """sign, Sylvester, Stein, CARE and DARE on the card against the CPU:
    the flags and ``iters`` equal, the solutions within 1e-4 of the
    largest entry."""
    from linalg_solver_tpu_torch import ops

    rng = np.random.RandomState(3)
    n, m = 48, 6
    f32 = np.float32
    shift = 3 * np.sqrt(n) * np.eye(n)
    cases = {
        "sign": (ops.sign_batched, ((rng.randn(4, n, n) + shift
                                     * rng.choice([-1, 1], (4, 1, n)))
                                    .astype(f32),)),
        "sylvester": (ops.sylvester_batched,
                      tuple((rng.randn(4, n, n) + s).astype(f32)
                            for s in (shift, shift, 0))),
        "stein": (ops.stein_batched,
                  ((rng.randn(4, n, n) * 0.4 / np.sqrt(n)).astype(f32),
                   np.tile(np.eye(n, dtype=f32), (4, 1, 1)))),
    }
    ga = (rng.randn(4, n, n) / np.sqrt(n)).astype(f32)
    bb = rng.randn(4, n, m).astype(f32)
    q = np.tile(np.eye(n, dtype=f32), (4, 1, 1))
    r = np.tile(np.eye(m, dtype=f32), (4, 1, 1))
    cases["care"] = (ops.care_batched, (ga / 2 - np.eye(n, dtype=f32),
                                        bb, q, r))
    cases["dare"] = (ops.dare_batched, (0.9 * ga, bb, q, r))
    for name, (fn, args) in cases.items():
        want = fn(*map(torch.from_numpy, args))
        got = fn(*(torch.from_numpy(x).to(cuda) for x in args))
        for f in want._fields:
            g, w = getattr(got, f).cpu(), getattr(want, f)
            if f in ("S", "X"):
                assert (g - w).abs().max() <= 1e-4 * w.abs().max(), name
            elif f in ("ok", "converged", "iters"):
                assert torch.equal(g, w), (name, f)
        assert bool(got[1].all()), name


@pytest.mark.cuda
def test_generalized_eigenproblems_on_the_card(cuda):
    """The three ``geig`` paths and ``quadeig`` on the card against the
    CPU: the flags and the count of infinite eigenvalues equal, the
    finite eigenvalues matched one to one within 1e-5 of the lane's
    largest (1e-4 through shift-invert, whose rounding grows with
    κ(A − σB))."""
    from scipy.optimize import linear_sum_assignment

    from linalg_solver_tpu_torch import ops

    rng = np.random.RandomState(4)
    n = 48
    f32 = np.float32
    g = rng.randn(3, n, n)
    h = rng.randn(3, n, n)
    spd = (h @ h.transpose(0, 2, 1) / n + np.eye(n)).astype(f32)
    bsing = (rng.randn(3, n, n) + 4 * np.sqrt(n) * np.eye(n)).astype(f32)
    bsing[0, :, -2:] = 0.0
    cases = (
        (ops.eigh_generalized_batched, ((g + g.transpose(0, 2, 1))
                                        .astype(f32), spd), 1e-5),
        (ops.eig_generalized_batched, (g.astype(f32), spd), 1e-5),
        (ops.eig_generalized_shifted_batched, (g.astype(f32), bsing), 1e-4),
        (ops.quadeig_batched, (spd[:, :24, :24], g[:, :24, :24].astype(f32),
                               h[:, :24, :24].astype(f32)), 1e-4),
    )
    for fn, args, tol in cases:
        want = fn(*map(torch.from_numpy, args))
        got = fn(*(torch.from_numpy(x).to(cuda) for x in args))
        assert torch.equal(got.ok.cpu(), want.ok)
        if hasattr(want, "w"):
            assert (got.w.cpu() - want.w).abs().max() <= tol * (
                want.w.abs().max())
            continue
        fw = getattr(want, "finite", torch.ones_like(want.valid))
        fg = getattr(got, "finite", fw).cpu()
        assert torch.equal(fg.sum(1), fw.sum(1))
        for b in range(want.real.shape[0]):
            lw = (want.real[b] + 1j * want.imag[b])[fw[b]].numpy()
            lg = (got.real[b] + 1j * got.imag[b]).cpu()[fg[b]].numpy()
            r, c = linear_sum_assignment(np.abs(lw[:, None] - lg[None]))
            assert np.abs(lw[r] - lg[c]).max() <= tol * np.abs(lw).max()


@pytest.mark.cuda
def test_eig_family_block_on_the_card(cuda):
    """``chip_smoke.py``'s family figures and limits at a small size on
    the card."""
    import chip_smoke

    from linalg_solver_tpu_torch import ops

    x = chip_smoke.eigf_inputs(bsz=2, n=32, roots_b=8, ric_n=16, quad_n=16)
    _, figs = chip_smoke.run_family(
        ops, x, lambda t: torch.from_numpy(t).to(cuda),
        lambda a: np.linalg.eigvals(a.astype(np.float64)))
    chip_smoke.hold_family(figs, bsz=2)


@pytest.mark.cuda
def test_shift_invert_floor_on_a_spread_pencil(cuda):
    """The shift-invert μ floor (``mu_floor·n·eps·‖M‖₁``, the reference's
    formula) on 4 seeded pencils P diag(linspace(−3, 7, 252), 1 × 4) Q,
    P diag(1 × 252, 0 × 4) Q at n = 256: 4 infinite eigenvalues a lane,
    and a finite spectrum spread on both sides of the first shift.  The
    floor grows with n and marks finite eigenvalues infinite: more than
    200 of the 256 columns on every lane (a known fault of both
    packages; a fix changes this test)."""
    from linalg_solver_tpu_torch import ops

    n = 256
    rng = np.random.RandomState(30)
    da = np.concatenate([np.linspace(-3.0, 7.0, n - 4), np.ones(4)])
    db = np.concatenate([np.ones(n - 4), np.zeros(4)])
    a = np.empty((4, n, n), np.float32)
    b = np.empty((4, n, n), np.float32)
    for k in range(4):
        p = rng.randn(n, n) * 0.4 / np.sqrt(n) + np.eye(n)
        q = rng.randn(n, n) * 0.4 / np.sqrt(n) + np.eye(n)
        a[k], b[k] = p * da @ q, p * db @ q
    res = ops.eig_generalized_shifted_batched(torch.from_numpy(a).to(cuda),
                                              torch.from_numpy(b).to(cuda))
    marked = (~res.finite).sum(1).tolist()
    assert min(marked) > 200, marked


def _trsyl_case(n, dtype, dev, seed):
    """A reordered complex Schur form [4, n, n] with m a lane (Re λ < 0 of
    three Gaussian lanes first), a right-hand side on the block, and a
    fourth lane, upper triangular, whose repeated eigenvalue 2 is split
    across the clusters (its denominators floored: pert)."""
    from linalg_solver_tpu_torch import ops

    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(3, n, n)).to(dev, dtype)
    sv = ops.real_schur_vectors(a)
    cs = ops.rsf2csf_batched(sv.T, sv.Q)
    sel = cs.t_re.diagonal(dim1=1, dim2=2) < 0
    t2 = np.triu(rng.randn(n, n))
    np.fill_diagonal(t2, np.r_[2.0, 2.0, np.arange(3, n + 1)])
    s2 = np.zeros(n, bool)
    s2[0] = True
    T = torch.cat([sv.T, torch.from_numpy(t2).to(dev, dtype)[None]])
    Q = torch.cat([sv.Q, torch.eye(n, dtype=dtype, device=dev)[None]])
    os = ops.schur_reorder_batched(T, Q, torch.cat(
        [sel, torch.from_numpy(s2).to(dev)[None]]))
    c = torch.from_numpy(rng.randn(2, 4, n, n)).to(dev, dtype)
    return os.t_re, os.t_im, os.m, c[0], c[1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("adjoint", [False, True])
def test_trsyl_kernel_matches_plain_version(cuda, n, dtype, adjoint):
    """The masked Sylvester kernel against its plain version on the same
    input, bitwise (both sum each row's product a term at a time in the
    same order and round every operation on its own), pert equal and set
    on the split lane only."""
    from linalg_solver_tpu_torch.ops.kernels import trsyl

    args = _trsyl_case(n, dtype, cuda, seed=n + adjoint)
    trsyl.LAUNCHES = 0
    xr, xi, pert = trsyl.trsyl_masked(*args, adjoint=adjoint)
    torch.cuda.synchronize()
    assert trsyl.LAUNCHES == 1
    rr, ri, rp = trsyl.trsyl_masked_reference(*args, adjoint=adjoint)
    assert torch.equal(xr, rr) and torch.equal(xi, ri)
    assert pert.tolist() == rp.tolist() == [False, False, False, True]
    m = args[2]
    block = ((torch.arange(n, device=cuda)[None, :, None] < m[:, None, None])
             & (torch.arange(n, device=cuda)[None, None, :]
                >= m[:, None, None]))
    assert float(xr.masked_fill(block, 0).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64, 256, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("adjoint", [False, True])
def test_trsyl_kernel_at_the_edges_of_m(cuda, n, dtype, adjoint):
    """m = 1 and m = n - 1 beside n / 2 (and the split lane's m = 1),
    bitwise against the plain version (on the CPU: the same operations
    rounded the same way), and a thread past 256 columns (n = 320)."""
    from linalg_solver_tpu_torch.ops.kernels import trsyl

    args = list(_trsyl_case(n, dtype, cuda, seed=n + 7))
    args[2] = torch.tensor([1, n - 1, n // 2, 1], dtype=torch.int32,
                           device=cuda)
    xr, xi, pert = trsyl.trsyl_masked(*args, adjoint=adjoint)
    torch.cuda.synchronize()
    rr, ri, rp = trsyl.trsyl_masked_reference(*[x.cpu() for x in args],
                                              adjoint=adjoint)
    assert torch.equal(xr.cpu(), rr) and torch.equal(xi.cpu(), ri)
    assert torch.equal(pert.cpu(), rp) and bool(rp[3])


@pytest.mark.cuda
def test_trsyl_kernel_reach(cuda):
    from linalg_solver_tpu_torch.ops.kernels import trsyl

    t = torch.zeros(1, 1025, 1025, device=cuda)
    m = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="no kernel"):
        trsyl.trsyl_masked(t, t, m, t, t)
    # an empty batch and an empty cluster launch nothing wrong
    e = torch.zeros(0, 8, 8, device=cuda)
    assert trsyl.trsyl_masked(e, e, m[:0], e, e)[0].shape == (0, 8, 8)
    z = torch.randn(2, 8, 8, device=cuda).triu()
    xr, xi, pert = trsyl.trsyl_masked(z, z, torch.tensor(
        [0, 8], dtype=torch.int32, device=cuda), z, z)
    assert float(xr.abs().max()) == 0.0 and not bool(pert.any())


@pytest.mark.cuda
def test_cluster_cond_launches_the_kernel(cuda):
    """schur_cluster_cond_batched launches the kernel 1 + 2 sep_iters
    times and runs no plain loop."""
    from linalg_solver_tpu_torch import ops
    from linalg_solver_tpu_torch.ops.kernels import trsyl

    a = torch.from_numpy(np.random.RandomState(1).randn(4, 48, 48)).to(
        cuda, torch.float32)
    sv = ops.real_schur_vectors(a)
    sel = ops.rsf2csf_batched(sv.T, sv.Q).t_re.diagonal(dim1=1, dim2=2) < 0
    plain = trsyl.trsyl_masked_reference
    trsyl.trsyl_masked_reference = None      # any call to it fails
    trsyl.LAUNCHES = 0
    try:
        cc = ops.schur_cluster_cond_batched(sv.T, sv.Q, sel, sep_iters=3)
        torch.cuda.synchronize()
    finally:
        trsyl.trsyl_masked_reference = plain
    assert trsyl.LAUNCHES == 7
    assert bool(((cc.s > 0) & (cc.s <= 1) & (cc.sep <= cc.gap + 1e-5)).all())


@pytest.mark.cuda
def test_matfun_block_on_the_card(cuda):
    """``chip_smoke.py``'s matrix-function figures and limits at a small
    size on the card."""
    import chip_smoke

    from linalg_solver_tpu_torch import ops

    small = {"bsz": 2, "n": 32, "ps_b": 2, "ps_n": 16, "fn_b": 2,
             "fn_n": 16, "near_b": 2, "near_n": 16, "fit_b": 2, "fit_m": 48,
             "fit_n": 16}
    x = chip_smoke.mf_inputs(**small)
    _, figs = chip_smoke.run_matfun(
        ops, x, lambda t: torch.from_numpy(t).to(cuda),
        chip_smoke.torch_grad, torch.exp)
    chip_smoke.hold_matfun(figs, bsz=2, ps_b=2, fn_b=2, near_b=2, fit_b=2)


@pytest.mark.cuda
def test_funm_inverse_runs_the_phase_engine(cuda):
    """``funm_batched`` at n = 96 inverts V through the 192 x 192 real
    embedding: the phase engine's butterfly and no-pivot panel kernels,
    and V V^-1 reconstructs A."""
    from linalg_solver_tpu_torch.ops import funm
    from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot

    rng = np.random.RandomState(31)
    a = torch.from_numpy(rng.randn(4, 96, 96).astype(np.float32)).to(cuda)
    butterfly.LAUNCHES = lu_nopivot.LAUNCHES = 0
    res = funm.funm_batched(a, torch.exp)
    torch.cuda.synchronize()
    assert butterfly.LAUNCHES >= 2 and lu_nopivot.LAUNCHES >= 1
    assert bool(res.ok.all()) and float(res.resid.max()) < 1e-4


@pytest.mark.cuda
def test_default_start_is_drawn_on_the_card(cuda):
    """A power iteration's default start is drawn on a generator of the
    card, not on the host."""
    from linalg_solver_tpu_torch.utils import draws

    (u,) = draws.start((4, 8), torch.float32, cuda)
    g = torch.Generator(device=cuda).manual_seed(draws.SEED)
    assert u.is_cuda and torch.equal(
        u, torch.randn(4, 8, generator=g, device=cuda))


@pytest.mark.cuda
def test_polar_on_the_card_sums_its_gram_in_float64(cuda):
    """On the card the QDWH polar factor is the probe's float64-Gram
    variant bit for bit, and TLS's x on 4 lanes of the fitting cell is
    inside the reference test's 2e-4."""
    import chip_smoke
    import test_torch_matfun_probe as probe

    from linalg_solver_tpu_torch.ops.svd import polar_batched

    a, b = chip_smoke.mf_inputs()["fit"]
    ab = torch.cat([torch.from_numpy(a[:4]),
                    torch.from_numpy(b[:4])[:, :, None]], 2).to(cuda)
    up, h = probe.polar_variant(ab, ("gram",))
    ref = polar_batched(ab)
    assert torch.equal(up, ref.up) and torch.equal(h, ref.H)
    assert probe.tls_probe(cuda, 4)["tls_batched"]["max"] <= 2e-4


def _sturm_case(B, n, seed, dev, dtype=torch.float32):
    from linalg_solver_tpu_torch.ops import sturm

    rng = np.random.RandomState(seed)
    d = torch.from_numpy(rng.randn(B, n)).to(dtype)
    e = torch.from_numpy(rng.randn(B, n - 1)).to(dtype)
    if n > 2:
        e[0, n // 2] = 0.0                   # a split chain
    e2 = torch.cat([torch.zeros(B, 1, dtype=dtype), e * e], dim=1)
    return (d.to(dev), e.to(dev), e2.to(dev),
            sturm._pivmin(e, dtype).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 40, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sturm_kernel_matches_plain_version(cuda, n, dtype):
    """The Sturm count and the 64-launch bisection against their plain
    versions on the CPU, bitwise (the same IEEE operations in the same
    order), with the same number of live steps; the enclosures are left
    as they were."""
    from linalg_solver_tpu_torch.ops.kernels import sturm as ks

    d, e, e2, pm = _sturm_case(6, n, n, cuda, dtype)
    x = torch.linspace(-3, 3, 17, dtype=dtype, device=cuda).expand(6, 17)
    ks.LAUNCHES = 0
    cnt = ks.sturm_count(d, e2, pm, x.contiguous())
    assert ks.LAUNCHES == 1
    assert torch.equal(cnt.cpu(), ks.sturm_count_reference(
        d.cpu(), e2.cpu(), pm.cpu(), x.cpu()))
    a = torch.full((6, n), -8.0, dtype=dtype, device=cuda)
    b = torch.full((6, n), 8.0, dtype=dtype, device=cuda)
    a1, b1, steps = ks.bisect(d, e2, pm, a, b)
    torch.cuda.synchronize()
    assert ks.LAUNCHES == 1 + ks.STEPS
    ra, rb, rsteps = ks.bisect_reference(d.cpu(), e2.cpu(), pm.cpu(),
                                         a.cpu(), b.cpu())
    assert torch.equal(a1.cpu(), ra) and torch.equal(b1.cpu(), rb)
    assert int(steps) == int(rsteps)
    assert float(a.max()) == -8.0 and float(b.min()) == 8.0


@pytest.mark.cuda
def test_sturm_eigenvalues_on_the_card(cuda):
    """``eigh_tridiagonal_batched`` on the card equals the plain path on
    the CPU bit for bit and float64 LAPACK to 1e-5 of ‖T‖; past the
    kernel's shared memory the wrapper raises."""
    import scipy.linalg

    from linalg_solver_tpu_torch.ops import sturm
    from linalg_solver_tpu_torch.ops.kernels import sturm as ks

    d, e, _, _ = _sturm_case(4, 512, 3, cuda)
    got = sturm.eigh_tridiagonal_batched(d, e)
    want = sturm.eigh_tridiagonal_batched(d.cpu(), e.cpu())
    assert torch.equal(got.w.cpu(), want.w)
    assert torch.equal(got.converged.cpu(), want.converged)
    ref = scipy.linalg.eigh_tridiagonal(d[1].double().cpu().numpy(),
                                        e[1].double().cpu().numpy(),
                                        eigvals_only=True)
    assert np.abs(got.w[1].double().cpu().numpy() - ref).max() < 1e-5 * (
        np.abs(ref).max())
    vec = sturm.tridiag_eigenvectors_batched(d, e, got.w)
    assert float(vec.resid.max()) < 1e-4
    big = torch.zeros(1, 40000, device=cuda)
    with pytest.raises(ValueError, match="no kernel"):
        ks.bisect(big, big, torch.ones(1, device=cuda), big, big + 1)


@pytest.mark.cuda
def test_cli_device_section_on_the_card(cuda, tmp_path):
    """``--device`` on the card: the heading and the replay name the GPU,
    the replayed derivation equals the exact path's, and the spectral
    table says every matrix is diagonalizable."""
    from linalg_solver_tpu_torch import cli
    from linalg_solver_tpu_torch.utils import trace

    text = trace.capture_logs(lambda: cli.device_section(2026))
    assert r"\section{Dávkový GPU řešič}" in text
    assert "řešena na GPU" in text
    assert text.count(" & ano \\\\") == 4
