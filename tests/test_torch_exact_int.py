"""The port's exact integer elimination (``linalg_solver_tpu_torch.ops
.exact_int``) against the JAX package's ``ops.exact_int``, fed the same
numpy inputs: every output exactly equal.

Bareiss in int32: det, rank and ok on BASELINE config 1's class (8×8
``randint(-5, 5)``, singular and rank-deficient lanes planted) and on
lanes with entries to 10⁴, where int32 overflows: there ``ok`` is False
in both and even the wrapped ``det`` is the reference's; two config-1
lanes where the reference's sentinel misses an overflow, so that both
return the same wrong ``det`` with ``ok`` True.  The exact
determinant of every ok lane against a Python-int one.  CRT: det, rank
and the rational solve, exactly."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import exact_int as jex
from linalg_solver_tpu_torch.ops import exact_int as tex


def _exact_det(m) -> int:
    m = [[Fraction(int(x)) for x in row] for row in m]
    n, det = len(m), Fraction(1)
    for j in range(n):
        p = next((i for i in range(j, n) if m[i][j] != 0), None)
        if p is None:
            return 0
        if p != j:
            m[j], m[p], det = m[p], m[j], -det
        det *= m[j][j]
        for i in range(j + 1, n):
            f = m[i][j] / m[j][j]
            m[i] = [x - f * y for x, y in zip(m[i], m[j])]
    return int(det)


def _config1(B=64, seed=0):
    a = np.random.RandomState(seed).randint(-5, 5, size=(B, 8, 8)).astype(
        np.int32)
    a[3, 2] = a[3, 5]                 # rank 7
    a[7] = 0                          # rank 0
    a[9, :, 1] = 2 * a[9, :, 4]       # rank 7
    return a


def _overflowing(B=4, n=8, seed=1):
    return np.random.RandomState(seed).randint(
        -10_000, 10_000, size=(B, n, n)).astype(np.int32)


@pytest.mark.parametrize("which", ["config1", "overflow"])
def test_bareiss_matches_jax_exactly(which):
    a = _config1() if which == "config1" else _overflowing()
    rj = jex.bareiss_batched(jnp.asarray(a))
    rt = tex.bareiss_batched(torch.from_numpy(a))
    for f in rj._fields:
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    assert rt.det.dtype == rt.rank.dtype == torch.int32
    if which == "overflow":
        assert not bool(rt.ok.any())
    else:
        assert rt.rank[[3, 7, 9]].tolist() == [7, 0, 7]
        for i in rt.ok.nonzero().flatten().tolist():
            assert int(rt.det[i]) == _exact_det(a[i])
        assert tex.bareiss_det_batched(torch.from_numpy(a)).equal(rt.det)
        assert tex.bareiss_rank_batched(torch.from_numpy(a)).equal(rt.rank)


def test_a_missed_overflow_is_the_reference_s():
    """The reference's sentinel bounds ``|M[i, j]·row_r|`` by
    ``max|M|·|pivot|``, which a small pivot breaks: on these two config-1
    matrices a product leaves int32 unflagged, and both packages return
    the same wrong determinant with ``ok`` True (the CRT path is exact)."""
    a = np.random.RandomState(1).randint(-5, 5, size=(4096, 8, 8)).astype(
        np.int32)[[368, 433]]
    rj = jex.bareiss_batched(jnp.asarray(a))
    rt = tex.bareiss_batched(torch.from_numpy(a))
    for f in rj._fields:
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)))
    exact = [_exact_det(m) for m in a]
    assert rt.ok.tolist() == [True, True]
    assert rt.det.tolist() != exact
    assert tex.crt_det_batched(torch.from_numpy(a)) == exact


def test_crt_det_and_rank_match_jax_exactly():
    a = np.concatenate([_overflowing(), _config1(B=12)[[0, 3, 7, 9]]])
    got = tex.crt_det_batched(torch.from_numpy(a))
    assert got == jex.crt_det_batched(jnp.asarray(a))
    assert got == [_exact_det(m) for m in a]
    c = _config1(B=12)
    np.testing.assert_array_equal(
        tex.crt_rank_batched(torch.from_numpy(c)),
        jex.crt_rank_batched(jnp.asarray(c)))


def test_crt_solve_matches_jax_exactly():
    a = _config1(B=10, seed=2)[[0, 1, 3, 7, 9, 2]]
    b = np.random.RandomState(3).randint(-5, 5, size=(6, 8)).astype(np.int32)
    xs, dets = tex.crt_solve_batched(torch.from_numpy(a), torch.from_numpy(b))
    assert (xs, dets) == jex.crt_solve_batched(jnp.asarray(a), jnp.asarray(b))
    assert xs[2] is None and xs[3] is None and dets[3] == 0
    x0 = xs[0]
    assert all(sum(int(a[0, i, j]) * x0[j] for j in range(8)) == b[0, i]
               for i in range(8))


@pytest.mark.parametrize("n,amax", [(4, 5), (8, 5), (3, 1000)])
def test_bareiss_safe_and_hadamard_bits_match_jax(n, amax):
    assert tex.bareiss_safe(n, amax) == jex.bareiss_safe(n, amax)
    assert tex._hadamard_bits(n, amax) == jex._hadamard_bits(n, amax)
