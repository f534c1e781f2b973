"""Butterfly pieces of the PyTorch port (``linalg_solver_tpu_torch.ops.rbt``)
against the JAX package's ``ops.rbt``: the same numpy inputs and the
same diagonals go through both."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from linalg_solver_tpu.ops import rbt as jrbt
from linalg_solver_tpu_torch.ops import rbt


def _jax_levels(seed, n, depth):
    return [
        np.asarray(v)
        for v in jrbt.rbt_diags(jax.random.PRNGKey(seed), n, depth,
                                jnp.float32)
    ]


def test_rbt_diags_distribution_and_shape():
    n, depth = 4096, 2
    d = rbt.rbt_diags(n, depth, torch.Generator().manual_seed(17))
    assert d.shape == (depth, n) and d.dtype == torch.float32
    assert d.device.type == "cpu"
    logs = torch.log(d).double()
    # exp(r / 10) with r ~ U(-1, 1): log in [-0.1, 0.1], mean 0,
    # std 0.1 / sqrt(3); 4096 draws put the sample mean within ~4.5
    # standard errors (0.0577 / 64 = 9e-4) of 0.
    assert logs.min() >= -0.1 - 1e-6 and logs.max() <= 0.1 + 1e-6
    assert abs(float(logs.mean())) < 4e-3
    assert abs(float(logs.std()) - 0.1 / np.sqrt(3.0)) < 3e-3
    again = rbt.rbt_diags(n, depth, torch.Generator().manual_seed(17))
    assert torch.equal(d, again)
    other = rbt.rbt_diags(n, depth, torch.Generator().manual_seed(29))
    assert not torch.equal(d, other)


@pytest.mark.parametrize("n", [2, 6, 64, 98, 100, 256])
def test_shrink_depth_matches_jax_rule(n):
    d = 2
    while (n >> (d - 1)) % 2:   # ops/rbt.py's pallas_solve_rbt_batched
        d -= 1
    assert rbt.shrink_depth(n) == max(d, 1)


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("depth", [1, 2])
def test_butterfly_apply_matches_jax(trans, depth):
    rng = np.random.RandomState(5 + depth + 2 * trans)
    B, N, K = 3, 64, 5
    x = rng.randn(B, N, K).astype(np.float32)
    levels = _jax_levels(17, N, depth)
    want = np.asarray(jrbt.butterfly_apply(
        jnp.asarray(x), [jnp.asarray(v) for v in levels], trans=trans
    ))
    diags = torch.from_numpy(np.stack(levels))
    got = rbt.butterfly_apply(torch.from_numpy(x), diags, trans=trans)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_butterfly_transpose_is_adjoint():
    """<Wᵀ x, y> == <x, W y>: the two level orders are transposes."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 32, 1))
    y = torch.from_numpy(rng.randn(2, 32, 1))
    diags = rbt.rbt_diags(32, 2, torch.Generator().manual_seed(1)).double()
    lhs = (rbt.butterfly_apply(x, diags, trans=True) * y).sum()
    rhs = (x * rbt.butterfly_apply(y, diags, trans=False)).sum()
    assert abs(float(lhs - rhs)) < 1e-12


@pytest.mark.parametrize("depth", [1, 2])
def test_diags_from_numpy_round_trip(depth):
    n = 64
    du, dv = _jax_levels(17, n, depth), _jax_levels(29, n, depth)
    U, V = rbt.diags_from_numpy(du, dv)
    for got, levels in ((U, du), (V, dv)):
        assert got.shape == (2, n) and got.dtype == torch.float32
        for lvl, want in enumerate(levels):
            np.testing.assert_array_equal(got[lvl].numpy(), want)
        if depth == 1:   # padded like diags_lanes: level 1 all ones
            assert torch.equal(got[1], torch.ones(n))
    # the [2, n] padding agrees with the JAX lane layout, lane by lane
    lanes = jrbt.diags_lanes(jax.random.PRNGKey(17), n, depth,
                             jnp.float32, 4)
    for lvl in range(2):
        np.testing.assert_array_equal(
            np.asarray(lanes[lvl])[:, 0], U[lvl].numpy()
        )


def test_pad_diags_keeps_two_levels():
    d2 = rbt.rbt_diags(8, 2, torch.Generator().manual_seed(0))
    assert torch.equal(rbt.pad_diags(d2), d2)
    d1 = d2[:1]
    p = rbt.pad_diags(d1)
    assert p.shape == (2, 8) and torch.equal(p[0], d1[0])


def test_default_diags_are_the_seeded_draws():
    n = 64
    U, V = rbt.default_diags(n, rbt.MAIN_SEEDS, "cpu")
    want_u = rbt.rbt_diags(n, 2, torch.Generator().manual_seed(17))
    want_v = rbt.rbt_diags(n, 2, torch.Generator().manual_seed(29))
    assert torch.equal(U, want_u) and torch.equal(V, want_v)
