"""The port's CUDA kernels on a card, against their plain PyTorch
versions.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from linalg_solver_tpu_torch.ops import dispatch, rbt
from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf
from linalg_solver_tpu_torch.utils import systems

# The kernel's panel-blocked LU and FMA contraction round differently
# from the plain version's rank-1 updates; both refine to the solution
# of a well-conditioned system, so they agree to a few f32 roundings of
# it (≤ 5e-7 measured on an H100).  1e-5 relative is the bound
# chip_smoke.py holds them to; the unrefined solution of the small-pivot
# probe system misses it by ~100x.
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
    (flagged only without the butterfly); 7 with a 1e-3 first pivot
    after the butterfly (off by ~1e-3 without refinement)."""
    a[2] = 0.0
    a[5, 3, 7] = float("nan")
    a[6] = systems.zero_minor_system(a[6])
    a[7] = systems.pivot_system(a[7], U, V, 1e-3)
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
    "N,k", [(64, 1), (64, 8), (100, 2), (98, 1), (256, 1)]
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
    its small-pivot system is off by far more than RTOL."""
    a, b = _batch(8, 64, seed=65, dev=cuda)
    U, V = rbt.default_diags(64, rbt.MAIN_SEEDS, str(cuda))
    a = _probe(a, U, V)
    x0, bad0 = sf.solve_fused_rbt(a, b, U, V, ir_steps=0)
    x_ref, bad_ref = sf.solve_fused_rbt_reference(a, b, U, V)
    assert _worst_rel(x0, bad0, x_ref, bad_ref) > 10 * RTOL


@pytest.mark.cuda
def test_smem_mirror_matches_the_kernel(cuda):
    from linalg_solver_tpu_torch.ops.kernels import _build

    lib = _build.load()
    for n in (2, 16, 64, 98, 100, 256, 574, 576, 794, 796, 1024):
        for k in (1, 2, 8):
            assert lib.solve_fused_smem_bytes(n, k) == sf.smem_bytes(n, k)


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
