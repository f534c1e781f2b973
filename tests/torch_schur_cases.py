"""Inputs and comparisons shared by the tests of the port's real Schur
solver (``tests/test_torch_schur*.py``) against the JAX package's
``ops.schur``: seeded numpy batches of every input kind, the JAX solver's
state as numpy, and the tolerances."""

import jax.numpy as jnp
import numpy as np
import torch

from linalg_solver_tpu.ops import schur as js

TOL = 1e-5


def _close(got, want, scale):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, float(scale))


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kinds(n, seed):
    """``[4, n, n]`` float32: Gaussian, skew, a defective Jordan
    similarity (a block of size min(3, n) at 2, the rest at −1), a
    companion matrix (roots 1 … n scaled into [−2, 2])."""
    rng = np.random.RandomState(seed)
    g = rng.randn(n, n)
    s = rng.randn(n, n)
    J = -np.eye(n)
    for i in range(min(3, n)):
        J[i, i] = 2.0
        if i + 1 < min(3, n):
            J[i, i + 1] = 1.0
    P = np.eye(n) + 0.3 * rng.randn(n, n)
    jor = P @ J @ np.linalg.inv(P)
    coeffs = np.poly(np.linspace(-2.0, 2.0, n))
    comp = np.zeros((n, n))
    comp[0, :] = -coeffs[1:]
    comp[np.arange(1, n), np.arange(n - 1)] = 1.0
    return np.stack([g, s - s.T, jor, comp]).astype(np.float32)


def _state(a, with_q):
    """The JAX solver's initial state (balanced, Hessenberg, padded) as
    numpy, shared by both sides."""
    H, Q, hi, stag, anorm, scale = js._schur_init(jnp.asarray(a),
                                                  with_q=with_q)
    return (np.asarray(H), np.asarray(Q) if with_q else None,
            np.asarray(hi), np.asarray(stag), np.asarray(anorm))


def _t(x):
    if x is None:
        return None
    t = torch.from_numpy(np.array(x))
    return t.long() if t.dtype == torch.int32 else t


def _swept_state(a, sweeps, npairs, aed_w):
    """The JAX solver's state after ``sweeps`` outer sweeps, as numpy."""
    H, Q, hi, stag, anorm, _ = js._schur_init(jnp.asarray(a), with_q=True)
    state = (H, Q, hi, stag, anorm, jnp.zeros(a.shape[0], bool))
    state, _ = js._schur_sweeps(state, sweeps, with_q=True, npairs=npairs,
                                aed_w=aed_w)
    return tuple(np.asarray(x) for x in state)


def _match_dev(ev, want, defective=2):
    """Per lane, the largest distance of ``ev`` from ``want`` under a
    greedy nearest matching.  On lane ``defective`` (``_kinds``' Jordan
    similarity) the three eigenvalues nearest 2 count by their mean: a
    defective eigenvalue's members scatter by ~eps^(1/3)·‖A‖ along the
    roundings of the path (so two correct solvers differ there by that
    much), their mean is as well-conditioned as a simple eigenvalue."""
    ev, want = np.array(ev), np.array(want)
    if defective is not None and ev.shape[1] >= 3:
        for x in (ev, want):
            near = np.argsort(np.abs(x[defective] - 2.0))[:3]
            x[defective, near] = x[defective, near].mean()
    out = []
    for got_l, want_l in zip(ev, want):
        left = list(want_l)
        worst = 0.0
        for z in sorted(got_l, key=lambda z: (z.real, z.imag)):
            j = int(np.argmin(np.abs(np.array(left) - z)))
            worst = max(worst, abs(left.pop(j) - z))
        out.append(worst)
    return np.array(out)
