"""The plain model of the Sturm bisection kernel's schedule
(``ops.kernels.sturm.bisect_schedule_reference``: a step counts one
midpoint for each run of bit-identical live neighbours, and an interval
a step left unchanged is frozen) against the plain bisection
``bisect_reference`` and the JAX package's ``eigh_tridiagonal_batched``,
to the bit, in float32 and float64, on the schedule's cases
(``tests/torch_sturm_cases.py``: exactly repeated eigenvalues of a split
matrix, a NaN lane, a lane converged on entry, an eigenvalue at 0, pivots
past the range of the kernel's fast float32 division, n = 1);
and on Gaussian lanes, fewer midpoints counted than B·n a step, each
step's count the distinct live intervals counted directly."""

import jax
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import sturm as jst
from linalg_solver_tpu_torch.ops import sturm as tst
from linalg_solver_tpu_torch.ops.kernels import sturm as kst
from torch_sturm_cases import CASES, nan_equal


def _jax_w(d, e, dtype):
    """The JAX package's eigenvalues of the float64 case in ``dtype``."""
    if dtype == torch.float64:
        with jax.enable_x64(True):
            return np.array(jst.eigh_tridiagonal_batched(d, e).w)
    return np.array(jst.eigh_tridiagonal_batched(d.astype(np.float32),
                                                 e.astype(np.float32)).w)


def _check_case(name, d, e, ops, a, b, steps):
    if name == "split_repeated":      # n/4 copies of 4 eigenvalues
        for lane in range(d.shape[0]):
            pairs = set(zip(a[lane].tolist(), b[lane].tolist()))
            assert len(pairs) == 4
    elif name == "nan_lane":
        assert bool(a[1].isnan().all()) and bool(b[1].isnan().all())
        assert bool(torch.isfinite(a[[0, 2]]).all())
    elif name == "converged_lane":
        a0, b0 = ops[3], ops[4]
        assert not bool(((b0 - a0) > kst.tolerance(a0, b0))[0].any())
        assert bool(((b0 - a0) > kst.tolerance(a0, b0))[1].all())
        assert steps > 0
    elif name == "zero_eigenvalues":   # the tail: lane 0 alone runs on
        alone = kst.bisect_reference(*(x[1:] for x in ops))[2]
        assert steps > int(alone)
    elif name == "wide_range":         # pivots past the fast range
        assert bool(torch.isfinite(a).all())
        assert float(a[0].abs().max()) > 2.0 ** 60
    else:
        assert d.shape[1] == 1 and steps > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_is_the_plain_bisection_and_the_jax_package(name):
    d, e = CASES[name]()
    B, n = d.shape
    for dtype in (torch.float32, torch.float64):
        ops = tst.bisect_operands(torch.from_numpy(d).to(dtype),
                                  torch.from_numpy(e).to(dtype))
        a, b, steps, counted = kst.bisect_schedule_reference(*ops)
        ra, rb, rsteps = kst.bisect_reference(*ops)
        steps = int(steps)
        assert nan_equal(a, ra) and nan_equal(b, rb)
        assert steps == int(rsteps)
        assert bool((counted[:steps] >= 1).all())
        assert bool((counted[:steps] <= B * n).all())
        assert not bool(counted[steps:].any())
        want = torch.from_numpy(_jax_w(d, e, dtype))
        assert want.dtype == dtype and nan_equal(0.5 * (a + b), want)
        _check_case(name, d, e, ops, a, b, steps)


def test_gaussian_lanes_count_fewer_midpoints():
    """A step counts the distinct (a, b) among the intervals no step has
    left unchanged; on Gaussian lanes that is far fewer than B·n a step
    over the run."""
    rng = np.random.RandomState(7)
    d = torch.from_numpy(rng.randn(4, 256).astype(np.float32))
    e = torch.from_numpy(rng.randn(4, 255).astype(np.float32))
    d, e2, pm, a, b = tst.bisect_operands(d, e)
    ma, mb, steps, counted = kst.bisect_schedule_reference(d, e2, pm, a, b)
    steps = int(steps)
    assert 0 < steps < kst.STEPS
    assert int(counted.sum()) < 0.6 * 4 * 256 * steps
    # the same counts from the plain loop's own states
    k = torch.arange(256)[None, :]
    frozen = torch.zeros(4, 256, dtype=torch.bool)
    for s in range(steps):
        want = 0
        for lane in range(4):
            live = ~frozen[lane]
            want += len(set(zip(kst._bits(a[lane][live]).tolist(),
                                kst._bits(b[lane][live]).tolist())))
        assert int(counted[s]) == want
        m = 0.5 * (a + b)
        below = kst.sturm_count_reference(d, e2, pm, m) <= k
        na, nb = torch.where(below, m, a), torch.where(below, b, m)
        frozen |= ((kst._bits(na) == kst._bits(a))
                   & (kst._bits(nb) == kst._bits(b)))
        a, b = na, nb
    assert torch.equal(a, ma) and torch.equal(b, mb)
