"""The port's two-sided butterfly (``linalg_solver_tpu_torch.ops.kernels
.butterfly``) against the JAX package's Pallas kernel
``ops.pallas.butterfly_kernel.butterfly_two_sided`` in interpret mode, on
the same numpy inputs and the same (JAX-drawn) diagonals.

On the CPU the wrapper runs its plain version.  XLA on the CPU may fuse a
product and a sum of the JAX kernel into one FMA where the port rounds
them apart, so the two agree to a rounding: rtol 1e-6 of each matrix's
largest entry (the ``TestButterflyKernel`` pattern)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu.ops.pallas import butterfly_kernel as jbf
from linalg_solver_tpu_torch.ops import rbt
from linalg_solver_tpu_torch.ops.kernels import butterfly


def _jax_levels(key, n, depth):
    return jrbt.rbt_diags(jax.random.PRNGKey(key), n, depth, jnp.float32)


@pytest.mark.parametrize("trans", [True, False], ids=["UtAV", "VXUt"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("B,n", [(3, 16), (3, 32), (5, 16), (5, 32)])
def test_matches_jax_kernel(B, n, depth, trans):
    """B = 5 takes the JAX kernel's batch padding (its tile is 8)."""
    a = np.random.RandomState(B + n + depth).randn(B, n, n).astype(
        np.float32)
    du, dv = _jax_levels(7, n, depth), _jax_levels(9, n, depth)
    want = np.asarray(jbf.butterfly_two_sided(
        jnp.asarray(a), tuple(du), tuple(dv), depth=depth,
        trans_rows=trans, trans_cols=trans, interpret=True))
    U, V = rbt.diags_from_numpy([np.asarray(v) for v in du],
                                [np.asarray(v) for v in dv])
    before = butterfly.LAUNCHES
    got = butterfly.butterfly_two_sided(torch.from_numpy(a), U, V, depth,
                                        trans, trans)
    assert butterfly.LAUNCHES == before        # CPU: the plain version
    assert got.shape == a.shape and got.dtype == torch.float32
    for i in range(B):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[i]).max())


def test_reconstruction_undoes_the_preconditioning():
    """``V (UᵀAV)⁻¹ Uᵀ = A⁻¹``: the two directions with swapped diagonals
    are the two halves of the inverse's sandwich."""
    n = 32
    rng = np.random.RandomState(3)
    a = torch.from_numpy(
        (rng.randn(2, n, n) + 4 * np.sqrt(n) * np.eye(n))).double()
    U, V = (d.double() for d in rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu"))
    a_p = butterfly.butterfly_two_sided_reference(a, U, V, 2, True, True)
    x = butterfly.butterfly_two_sided_reference(
        torch.linalg.inv(a_p.double()), V, U, 2, False, False)
    # the plain version computes in f32
    err = (x.double() - torch.linalg.inv(a)).abs().max()
    assert float(err) <= 1e-6 * float(torch.linalg.inv(a).abs().max())


def test_mixed_sides_are_the_one_sided_passes():
    n = 16
    a = torch.from_numpy(np.random.RandomState(4).randn(2, n, n)).float()
    U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    got = butterfly.butterfly_two_sided(a, U, V, 2, True, False)
    want = rbt.butterfly_apply(a, U, trans=True)
    want = rbt.butterfly_apply(want.transpose(1, 2), V, trans=False)
    assert torch.equal(got, want.transpose(1, 2))


def test_fits_and_rejects():
    assert butterfly.fits(16, 2) and butterfly.fits(6, 1)
    assert not butterfly.fits(6, 2) and not butterfly.fits(7, 1)
    assert not butterfly.fits(16, 3) and not butterfly.fits(2, 2)
    U, V = rbt.default_diags(16, rbt.MAIN_SEEDS, "cpu")
    with pytest.raises(ValueError, match="multiple of 2"):
        butterfly.butterfly_two_sided(torch.zeros(1, 18, 18), U, V, 2)
    with pytest.raises(ValueError, match="diags_rows"):
        butterfly.butterfly_two_sided(torch.zeros(1, 16, 16), U[:1], V, 2)
    with pytest.raises(ValueError, match=r"\[B, N, N\]"):
        butterfly.butterfly_two_sided(torch.zeros(1, 16, 8), U, V, 2)
