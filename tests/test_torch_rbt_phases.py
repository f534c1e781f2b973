"""The port's RBT phase engine (``linalg_solver_tpu_torch.ops.rbt``,
``engine="kernel"``) and the ``lu_blocked`` pieces it uses, against the
JAX package on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode with
``factor_precision="float32"``; the port runs its plain versions on the
CPU, fed the JAX butterfly draws (keys 17/29, redraw 101/103) through
``diags_from_numpy``.  The two differ by a rounding here and there (XLA
fuses some products and sums into FMAs, and the JAX panel kernel folds
its steps), so solutions and inverses agree to 1e-5 of each system's
largest entry, and the rescue-free passes raise exactly the same
per-system flags.

Some of its cases live in ``tests/test_torch_rbt_phase_inverse.py``
(files of at most 11 tests: pytest-xdist's ``--dist loadfile`` queues a
file by its number of tests, and so queues these after the slow JAX file
``tests/test_lu_large.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import lu_blocked as jlub
from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu_torch.ops import lu_blocked, rbt
from linalg_solver_tpu_torch.ops.kernels import butterfly, lu_nopivot
from linalg_solver_tpu_torch.ops.kernels import solve_fused as sf
from linalg_solver_tpu_torch.utils import precision, systems

RTOL = 1e-5


def _jax_diags(n, keys):
    d = rbt.shrink_depth(n)
    return rbt.diags_from_numpy(*(
        [np.asarray(v) for v in jrbt.rbt_diags(
            jax.random.PRNGKey(key), n, d, jnp.float32)]
        for key in keys
    ))


def _probe_batch(B, n, seed):
    """Gaussian + 4√n·I with 1 a zero first pivot under the JAX main draw
    (flagged, the redraw solves it), 2 a zero leading minor (hostile to
    pivot-free LU without the butterfly) and 3 all zero (every rung
    fails; it ends in the pivoted solver)."""
    rng = np.random.RandomState(seed)
    a = (rng.randn(B, n, n) + 4.0 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)
    U, V = _jax_diags(n, rbt.MAIN_SEEDS)
    a[1] = systems.pivot_system(torch.from_numpy(a[1]), U, V, 0.0).numpy()
    a[2] = systems.zero_minor_system(torch.from_numpy(a[2])).numpy()
    a[3] = 0.0
    return a, rng


def _assert_close(got, want, lanes):
    for i in lanes:
        err = np.abs(got[i] - want[i]).max()
        assert err <= RTOL * np.abs(want[i]).max(), (i, err)


@pytest.mark.parametrize("ir_steps", [0, 1, 2])
def test_phase_solve_matches_jax(ir_steps):
    B, n, nb, k = 5, 64, 16, 16
    a, rng = _probe_batch(B, n, seed=60 + ir_steps)
    b = rng.randn(B, n, k).astype(np.float32)
    draw = _jax_diags(n, rbt.MAIN_SEEDS)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    _, bad = rbt._solve_core(at, bt, draw, nb, ir_steps, "float32")
    _, bad_j = jrbt._solve_core(jnp.asarray(a), jnp.asarray(b), nb,
                                ir_steps, "float32", 2, rbt.MAIN_SEEDS,
                                True, 32, True)
    assert bad.tolist() == np.asarray(bad_j).tolist()
    assert bad.tolist() == [False, True, False, True, False]

    before = (butterfly.LAUNCHES, lu_nopivot.LAUNCHES)
    xt = rbt.solve_rbt_batched(
        at, bt, ir_steps=ir_steps, diags=draw,
        rescue_diags=_jax_diags(n, rbt.RESCUE_SEEDS), nb=nb,
        factor_precision="float32").numpy()
    assert (butterfly.LAUNCHES, lu_nopivot.LAUNCHES) == before  # CPU
    xj = np.asarray(jrbt.pallas_solve_rbt_batched(
        jnp.asarray(a), jnp.asarray(b), nb=nb, ir_steps=ir_steps,
        factor_precision="float32", engine="kernel", interpret=True))
    assert xt.shape == xj.shape == b.shape
    _assert_close(xt, xj, [0, 1, 2, 4])
    assert not np.isfinite(xt[3]).all() and not np.isfinite(xj[3]).all()


def test_solve_takes_the_fused_kernel_up_to_k8_and_the_phases_past():
    """Clean systems, so no rescue: the result is the chosen engine's."""
    rng = np.random.RandomState(7)
    n = 32
    a = torch.from_numpy(
        (rng.randn(2, n, n) + 4 * np.sqrt(n) * np.eye(n)).astype(np.float32))
    draw = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    b = torch.from_numpy(rng.randn(2, n, 8).astype(np.float32))
    fused, _ = sf.solve_fused_rbt(a, b, *draw)
    assert torch.equal(rbt.solve_rbt_batched(a, b), fused)
    b = torch.from_numpy(rng.randn(2, n, 9).astype(np.float32))
    phases, _ = rbt._solve_core(a, b, draw, 32, 2, "bfloat16")
    assert torch.equal(rbt.solve_rbt_batched(a, b), phases)


def test_phase_rescue_leaves_the_other_systems_bitwise_unchanged():
    n, k = 64, 12
    a, rng = _probe_batch(6, n, seed=9)
    clean = (rng.randn(6, n, n) + 4 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)
    b = torch.from_numpy(rng.randn(6, n, k).astype(np.float32))
    x0 = rbt.solve_rbt_batched(torch.from_numpy(clean), b, diags=_jax_diags(
        n, rbt.MAIN_SEEDS))
    clean[1:4] = a[1:4]
    x = rbt.solve_rbt_batched(torch.from_numpy(clean), b, diags=_jax_diags(
        n, rbt.MAIN_SEEDS))
    for i in (0, 4, 5):
        assert torch.equal(x[i], x0[i]), i
    assert torch.isfinite(x[[1, 2]]).all() and not torch.isfinite(x[3]).all()


def test_phase_nb_picks_the_reference_widths_that_fit():
    assert rbt.phase_nb(256, None, rbt.SOLVE_NB_SMALL) == 32
    assert rbt.phase_nb(256, None, rbt.INVERSE_NB) == 64
    assert rbt.phase_nb(896, None, rbt.SOLVE_NB_LARGE) == 64
    # 960 x 64 is past the panel kernel's shared memory: the next width
    assert not lu_nopivot.fits(960, 64)
    assert rbt.phase_nb(960, None, rbt.INVERSE_NB) == 48
    assert rbt.phase_nb(100, None, rbt.SOLVE_NB_SMALL) == 100  # one panel
    assert rbt.phase_nb(16, 64, rbt.INVERSE_NB) == 16
    with pytest.raises(ValueError, match="even N"):
        rbt.phase_nb(63, None, rbt.SOLVE_NB_SMALL)
    with pytest.raises(ValueError, match="multiple of nb=48"):
        rbt.phase_nb(64, 48, rbt.SOLVE_NB_SMALL)
    with pytest.raises(ValueError, match="shared memory"):
        rbt.phase_nb(1024, 1024, rbt.INVERSE_NB)


@pytest.mark.parametrize("n", [16, 128])
def test_triangular_inverses_match_jax(n):
    """n = 128 takes one divide-and-conquer level above the Neumann base."""
    rng = np.random.RandomState(n)
    m = rng.randn(3, n, n).astype(np.float32) / np.sqrt(n)
    lo = np.tril(m, -1) + np.eye(n, dtype=np.float32)
    up = np.triu(m) + 2.0 * np.eye(n, dtype=np.float32)
    for ours, theirs, t in ((lu_blocked.invert_unit_lower,
                             jlub.invert_unit_lower, lo),
                            (lu_blocked.invert_upper, jlub.invert_upper, up)):
        got = ours(torch.from_numpy(t)).numpy()
        want = np.asarray(theirs(jnp.asarray(t)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * np.abs(want).max())
        np.testing.assert_allclose(
            np.einsum("bij,bjk->bik", t.astype(np.float64), got),
            np.broadcast_to(np.eye(n), t.shape), rtol=0, atol=1e-5)


def test_blocked_inverse_matches_jax_and_leaves_singular_non_finite():
    n = 32
    rng = np.random.RandomState(2)
    a = (rng.randn(3, n, n) + 4 * np.sqrt(n) * np.eye(n)).astype(np.float32)
    a[1] = 0.0
    got = lu_blocked.blocked_inverse_batched(torch.from_numpy(a)).numpy()
    want = np.asarray(jlub.blocked_inverse_batched(jnp.asarray(a), nb=16))
    _assert_close(got, want, [0, 2])
    assert not np.isfinite(got[1]).all()


def test_factor_matmuls_sets_and_restores_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    with precision.factor_matmuls("bfloat16"):
        assert torch.backends.cuda.matmul.allow_tf32
        with precision.f32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    with precision.factor_matmuls("float32"):
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == saved
    with pytest.raises(ValueError, match="factor_precision"):
        precision.factor_matmuls("float16")
