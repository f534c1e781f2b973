"""The port's pseudospectra (``linalg_solver_tpu_torch.ops.pseudospectra``)
against the JAX package, fed the same matrices and the JAX package's own
random start (``jax.random.normal(PRNGKey(0), (2, G, n))``).

σmin within 1e-4 relative of the JAX package's: through the whole entry
point (each package's own Schur form; σmin(T − zI) does not depend on
the unitary basis), and through the inverse iteration alone on the same
complex Schur form.  Both against numpy's float64 SVD, and the grid's
layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import ordschur as jord
from linalg_solver_tpu.ops import pseudospectra as jps
from linalg_solver_tpu.ops.schur import real_schur_vectors as jschur
from linalg_solver_tpu_torch.ops import pseudospectra as tps

B, N = 3, 10
TOL = 1e-4


def _start(G, n):
    u = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, G, n),
                                   jnp.float32))
    return u[0], u[1]


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    A = (rng.randn(B, N, N) / np.sqrt(N)).astype(np.float32)
    zr = np.array([-1.0, -0.4, 0.0, 0.3, 0.9], np.float32)
    zi = np.array([-0.5, 0.2, 0.0, 0.7, -0.1], np.float32)
    return A, zr, zi


def _svd_sigmin(a, z):
    return np.linalg.svd(a.astype(np.float64) - z * np.eye(a.shape[-1]),
                         compute_uv=False)[-1]


def test_points_match_jax_and_svd(case):
    A, zr, zi = case
    rj = jps.sigmin_points_batched(jnp.asarray(A), jnp.asarray(zr),
                                   jnp.asarray(zi))
    rt = tps.sigmin_points_batched(torch.from_numpy(A), zr, zi,
                                   u0=_start(len(zr), N))
    assert rt._fields == rj._fields
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    sj = np.asarray(rj.sigmin, np.float64)
    st = rt.sigmin.double().numpy()
    assert (np.abs(st - sj) <= TOL * sj).all()
    for b in range(B):
        for g in range(len(zr)):
            want = _svd_sigmin(A[b], zr[g] + 1j * zi[g])
            assert abs(st[b, g] - want) <= TOL * want


def test_core_on_the_same_schur_form(case):
    A, zr, zi = case
    sv = jschur(jnp.asarray(A), balance=False)
    cs = jord.rsf2csf_batched(sv.T, sv.Q)
    sj = np.asarray(jps._sigmin_core(cs.t_re, cs.t_im, jnp.asarray(zr),
                                     jnp.asarray(zi), 20), np.float64)
    t = torch.complex(torch.from_numpy(np.array(cs.t_re)),
                      torch.from_numpy(np.array(cs.t_im)))
    ur, ui = _start(len(zr), N)
    st = tps._sigmin_core(t, torch.complex(torch.from_numpy(zr),
                                           torch.from_numpy(zi)),
                          torch.complex(torch.from_numpy(ur),
                                        torch.from_numpy(ui)), 20)
    assert (np.abs(st.double().numpy() - sj) <= TOL * sj).all()


def test_point_on_an_eigenvalue_is_tiny():
    """At an exact eigenvalue the floored pivot keeps σmin at the roundoff
    level (finite, not hidden)."""
    A = np.diag(np.arange(1.0, 7.0)).astype(np.float32)[None]
    res = tps.sigmin_points_batched(torch.from_numpy(A), [2.0], [0.0])
    s = res.sigmin.numpy()
    assert np.isfinite(s).all() and s[0, 0] < 1e-5


def test_grid_layout_matches_jax(case):
    A, _, _ = case
    re = np.linspace(-1.5, 1.5, 4).astype(np.float32)
    im = np.linspace(-1.0, 1.0, 3).astype(np.float32)
    rj = jps.pseudospectrum_grid_batched(jnp.asarray(A), jnp.asarray(re),
                                         jnp.asarray(im))
    # the JAX draw for the flattened (im, re) grid, row-major
    rt = tps.pseudospectrum_grid_batched(torch.from_numpy(A), re, im,
                                         u0=_start(12, N))
    assert tuple(rt.sigmin.shape) == (B, 3, 4)
    sj = np.asarray(rj.sigmin, np.float64)
    assert (np.abs(rt.sigmin.double().numpy() - sj) <= TOL * sj).all()
    assert abs(float(rt.sigmin[1, 2, 3]) - _svd_sigmin(
        A[1], re[3] + 1j * im[2])) <= TOL * float(rt.sigmin[1, 2, 3])


def test_generator_start_is_seeded(case):
    A, zr, zi = case
    runs = [tps.sigmin_points_batched(
        torch.from_numpy(A), zr, zi,
        generator=torch.Generator().manual_seed(5)).sigmin for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_default_start_is_the_seeded_draw_on_the_device():
    """Without ``u0`` or a generator the start is ``SEED``'s draw on a
    generator of the input's device; a given start is cast to the dtype
    and device."""
    from linalg_solver_tpu_torch.utils import draws

    ur, ui = draws.start((3, 5), torch.float32, "cpu", parts=2)
    g = torch.Generator().manual_seed(draws.SEED)
    assert torch.equal(ur, torch.randn(3, 5, generator=g))
    assert torch.equal(ui, torch.randn(3, 5, generator=g))
    (x,) = draws.start((2,), torch.float64, "cpu",
                       given=np.array([1.0, 2.0], np.float32))
    assert x.dtype == torch.float64 and x.tolist() == [1.0, 2.0]
