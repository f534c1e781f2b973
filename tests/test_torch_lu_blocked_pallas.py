"""The port's pivoted phase loop on panel kernel 6 (``linalg_solver_tpu_torch
.ops.lu_blocked``: ``pallas_solve_batched``, ``pallas_solve_mixed_batched``,
``pallas_det_batched``, ``blocked_lu_batched`` (the JAX package's
``panel_backend="pallas"``),
``blocked_lu_solve`` and ``blocked_inverse_batched(panel_backend=
"pallas")``) against the same functions of the JAX package, their panel
kernel in interpret mode, on the same numpy inputs.

Both pick the same pivots (``perm``, ``sign`` and ``ok`` equal).  Values
agree to 1e-5 of each system's largest entry: the panel kernels agree to
the bit, but the trailing products sum in another order in XLA and in
torch (and on the CPU the JAX package's ``"bfloat16"`` factor precision
is full f32, as the port's is).

Some of its cases live in ``tests/test_torch_lu_mixed.py`` (files of at
most 11 tests: pytest-xdist's ``--dist loadfile`` queues a file by its
number of tests, and so queues these after the slow JAX file
``tests/test_lu_large.py``)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import lu_blocked as jlub
from linalg_solver_tpu_torch.ops import lu_blocked
from linalg_solver_tpu_torch.ops.kernels import lu_panel

RTOL = 1e-5


def _batch(B, n, seed, k=None):
    rng = np.random.RandomState(seed)
    a = (rng.randn(B, n, n) + 4.0 * np.sqrt(n) * np.eye(n)).astype(
        np.float32)
    shape = (B, n) if k is None else (B, n, k)
    return a, rng.randn(*shape).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for i in range(got.shape[0]):
        err = np.abs(got[i] - want[i]).max()
        assert err <= rtol * np.abs(want[i]).max(), (i, err)


def _resid(a, b, x):
    b3 = b.reshape(b.shape[0], b.shape[1], -1).astype(np.float64)
    r = np.einsum("bij,bjk->bik", a.astype(np.float64),
                  np.asarray(x).reshape(b3.shape)) - b3
    return np.abs(r).max(axis=(1, 2)) / np.abs(b3).max(axis=(1, 2))


@pytest.mark.parametrize("k", [None, 3], ids=["vector", "k3"])
def test_pallas_solve_matches_jax(k):
    a, b = _batch(3, 32, seed=1, k=k)
    before = lu_panel.LAUNCHES
    xt = lu_blocked.pallas_solve_batched(torch.from_numpy(a),
                                         torch.from_numpy(b), nb=8)
    assert lu_panel.LAUNCHES == before            # CPU: the plain version
    xj = jlub.pallas_solve_batched(jnp.asarray(a), jnp.asarray(b), nb=8,
                                   interpret=True)
    _close(xt.numpy(), xj)
    assert _resid(a, b, xt.numpy()).max() <= 1e-5


def test_two_level_panel_is_the_one_level_factorization():
    """The reference's own claim for the split: the same pivots and the
    same factors, to f32 rounding of the inner products."""
    a, _ = _batch(2, 32, seed=6)
    one = lu_blocked._pallas_lu(torch.from_numpy(a), 16)
    two = lu_blocked._pallas_lu(torch.from_numpy(a), 16, nbi=4)
    assert torch.equal(one.perm, two.perm) and torch.equal(one.ok, two.ok)
    _close(two.lu.numpy(), one.lu.numpy())


def _growth_system(n):
    """Wilkinson's matrix: partial pivoting takes the diagonal and the last
    column doubles each step (growth 2^(n−1)); at n = 64 an f32
    factorization solves it badly and refinement with it does not
    converge."""
    w = np.eye(n, dtype=np.float32) - np.tril(np.ones((n, n), np.float32), -1)
    w[:, -1] = 1.0
    return w


def test_pallas_det_matches_jax():
    rng = np.random.RandomState(8)
    n = 32
    a = (np.eye(n) + rng.randn(4, n, n) / (2 * np.sqrt(n))).astype(
        np.float32)
    a[2, [0, 5]] = a[2, [5, 0]]             # an odd permutation
    a[3] = 0.0                              # singular: det 0, not NaN
    dt = lu_blocked.pallas_det_batched(torch.from_numpy(a), nb=8).numpy()
    dj = np.asarray(jlub.pallas_det_batched(jnp.asarray(a), nb=8,
                                            interpret=True))
    np.testing.assert_allclose(dt, dj, rtol=RTOL)
    np.testing.assert_allclose(dt[:3], np.linalg.det(a[:3].astype(
        np.float64)), rtol=1e-4)
    assert dt[3] == 0.0


@pytest.mark.parametrize("nb", [8, 32])
def test_blocked_lu_matches_jax(nb):
    """``nb = 32 = N``: one panel."""
    a, _ = _batch(3, 32, seed=nb)
    rt = lu_blocked.blocked_lu_batched(torch.from_numpy(a), nb=nb)
    rj = jlub.blocked_lu_batched(jnp.asarray(a), nb=nb,
                                 panel_backend="pallas", interpret=True)
    assert rt.perm.dtype == torch.int32
    assert rt.perm.tolist() == np.asarray(rj.perm).tolist()
    assert rt.sign.tolist() == np.asarray(rj.sign).tolist()
    assert rt.ok.tolist() == np.asarray(rj.ok).tolist() == [True] * 3
    _close(rt.lu.numpy(), rj.lu)
    _close(rt.l11_inv.numpy(), rj.l11_inv)
    _close(rt.u11_inv.numpy(), rj.u11_inv)
    # P A = L U
    n = a.shape[-1]
    lu = rt.lu.double()
    lo = torch.tril(lu, -1) + torch.eye(n, dtype=torch.float64)
    pa = torch.from_numpy(a).double().gather(
        1, rt.perm.long()[:, :, None].expand(-1, -1, n))
    assert float((lo @ torch.triu(lu) - pa).abs().max()) <= 1e-5 * np.abs(
        a).max()


def test_blocked_lu_solve_matches_jax():
    """Through the cached diagonal-block inverses, against the JAX
    ``blocked_lu_solve`` of the JAX factorization; a panel width that
    does not divide N raises, on every phase-loop entry."""
    a, b = _batch(2, 32, seed=11, k=2)
    at = torch.from_numpy(a)
    res = lu_blocked.blocked_lu_batched(at, nb=8)
    x = lu_blocked.blocked_lu_solve(res, torch.from_numpy(b))
    rj = jlub.blocked_lu_batched(jnp.asarray(a), nb=8,
                                 panel_backend="pallas", interpret=True)
    _close(x.numpy(), jlub.blocked_lu_solve(rj, jnp.asarray(b), nb=8))
    assert _resid(a, b, x.numpy()).max() <= 1e-5
    for entry in (lu_blocked.blocked_lu_batched, lu_blocked.pallas_det_batched):
        with pytest.raises(ValueError, match="divisible"):
            entry(at, nb=12)


def test_blocked_inverse_pallas_matches_jax():
    """The JAX ``blocked_inverse_batched`` takes no ``interpret``: its
    body, ``blocked_lu_solve`` of the factorization against I, is run
    here with the panel kernel in interpret mode."""
    a, _ = _batch(3, 32, seed=12)
    xt = lu_blocked.blocked_inverse_batched(torch.from_numpy(a), nb=8,
                                            panel_backend="pallas")
    res = jlub.blocked_lu_batched(jnp.asarray(a), nb=8,
                                  panel_backend="pallas", interpret=True)
    xj = jlub.blocked_lu_solve(res, jnp.broadcast_to(jnp.eye(32), a.shape),
                               nb=8)
    _close(xt.numpy(), xj)
    eye = np.eye(32)
    r = np.einsum("bij,bjk->bik", a.astype(np.float64), xt.numpy()) - eye
    assert np.abs(r).max() <= 5e-5


def test_panel_split_takes_the_widest_sub_panel_that_fits():
    assert lu_blocked.panel_split(256, 64) is None
    assert lu_blocked.panel_split(960, 64) == 32
    assert lu_blocked.panel_split(2048, 64) == 16
    assert lu_blocked.panel_split(64, 16, nbi=4) == 4
    with pytest.raises(ValueError, match="must divide"):
        lu_blocked.panel_split(64, 16, nbi=6)
