"""The port's Jordan analysis and spectral pipeline
(``linalg_solver_tpu_torch.models.jordan`` / ``.spectral``) against the
JAX package's ``models.jordan`` / ``.spectral``, on the JAX generators'
batches as numpy.

Exact: Weyr characteristics, multiplicities, block counts, nullities,
``diagonalizable``.  Values: eigenvalues within 1e-5 of max|A| (eigh)
and 1e-4 (the QR route); ``P``, ``P⁻¹``, ``D`` within 1e-4 of their
largest entry, where the eigh route's sign freedom makes the test
compare spans (``P D Pᵀ`` and per-column ``|⟨p, q⟩|``) instead of
vectors; null bases from the SVD as projectors (singular vectors differ
in sign between the two libraries).  The Schur routes (``"schur"``,
``"eig"``, ``"auto"`` on a non-symmetric batch) against the reference's
on the same batch; a method the pipeline does not name takes the QR
route, as in the reference; the refusal of the mesh is checked by
message.

Some of its cases live in ``tests/test_torch_spectral_routes.py`` (files
of at most 11 tests: pytest-xdist's ``--dist loadfile`` queues a file by
its number of tests, and so queues these after the slow JAX file
``tests/test_lu_large.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.models import jordan as jjor
from linalg_solver_tpu.models import spectral as jspec
from linalg_solver_tpu.ops import generate as jgen
from linalg_solver_tpu_torch.models import jordan as tjor
from linalg_solver_tpu_torch.models import spectral as tspec

RTOL = 1e-4
#: a small config 5: blocks at 2 (sizes 3, 2, 1), at 5 (2, 2), at 1 (1)
BLOCKS = ((2.0, 3), (2.0, 2), (2.0, 1), (5.0, 2), (5.0, 2), (1.0, 1))
EIGS = (2.0, 5.0, 1.0)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1.0)


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def jordan_batch():
    return np.array(jgen.jordan_batch(jax.random.PRNGKey(7), 3, BLOCKS,
                                      transform="orthogonal"))


def test_jordan_analysis_per_lane_eigenvalues(jordan_batch):
    """``eigenvalues [B, E]``: a lane asked about an eigenvalue it does
    not have reports zero there."""
    a = jordan_batch
    lam = np.array([[2.0, 5.0], [5.0, 1.0], [3.0, 2.0]], np.float32)
    rj = jjor.jordan_analysis(jnp.asarray(a), jnp.asarray(lam), k_max=3)
    rt = tjor.jordan_analysis(torch.from_numpy(a), torch.from_numpy(lam),
                              k_max=3)
    for f in rj._fields:
        _exact(getattr(rt, f), getattr(rj, f))
    assert rt.alg_mult.tolist() == [[6, 4], [4, 1], [0, 6]]


def test_jordan_analysis_rejects_an_unknown_method(jordan_batch):
    with pytest.raises(ValueError, match="rank method"):
        tjor.jordan_analysis(torch.from_numpy(jordan_batch), EIGS,
                             method="lu")


@pytest.fixture(scope="module")
def symmetric_batch():
    """Config 4 in small: an orthogonal similarity of diag(1 x 3, 2 x 3,
    5 x 2), as the reference generates it."""
    eigs = [1.0] * 3 + [2.0] * 3 + [5.0] * 2
    return np.array(jgen.diagonalizable_batch(
        jax.random.PRNGKey(0), 3, eigs, transform="orthogonal")), eigs


@pytest.mark.parametrize("method", ["eigh", "auto"])
def test_eigh_pipeline_matches_jax(symmetric_batch, method):
    a, eigs = symmetric_batch
    rj = jspec.spectral_pipeline(jnp.asarray(a), tol=1e-2, method=method)
    rt = tspec.spectral_pipeline(torch.from_numpy(a), tol=1e-2,
                                 method=method)
    for f in ("alg_mult", "geom_mult", "diagonalizable"):
        _exact(getattr(rt, f), getattr(rj, f))
    scale = np.abs(a).max()
    assert np.abs(rt.eig_real.numpy() - np.asarray(rj.eig_real)).max() <= \
        1e-5 * scale
    assert rt.alg_mult[0].tolist() == [2, 2, 3, 3, 3, 3, 3, 3]
    # spans: the reconstruction and, where an eigenvalue repeats, the
    # eigenspace's projector
    P, Pj = rt.P.numpy().astype(np.float64), np.asarray(rj.P, np.float64)
    _close(P @ rt.D.numpy() @ rt.P_inv.numpy(), a)
    _close(rt.P_inv.numpy(), P.transpose(0, 2, 1))
    for lo, hi in ((0, 2), (2, 5), (5, 8)):
        _close(P[:, :, lo:hi] @ P[:, :, lo:hi].transpose(0, 2, 1),
               Pj[:, :, lo:hi] @ Pj[:, :, lo:hi].transpose(0, 2, 1))
    _close(rt.D.numpy(), rj.D)


@pytest.fixture(scope="module")
def nonsymmetric_batch():
    """B = 4, n = 16, not symmetric: ``P diag(λ) P⁻¹`` with λ = 1 … 4,
    four times each (lanes 0-1; P = I + G/8) and distinct reals
    ``1 + 4i/15`` (lanes 2-3), float64 on the host, rounded."""
    rng = np.random.RandomState(11)
    lam = np.stack([np.repeat(np.arange(1.0, 5.0), 4)] * 2
                   + [1.0 + 4.0 * np.arange(16) / 15] * 2)
    P = np.eye(16) + rng.randn(4, 16, 16) / 8
    a = np.einsum("bij,bj,bjk->bik", P, lam, np.linalg.inv(P))
    return a.astype(np.float32)


def test_sharded_pipeline_raises_naming_its_item():
    """Without a ``DeviceMesh`` the sharded pipeline refuses by name (it
    is held against the JAX package in ``test_torch_models_parallel.py``)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tspec.spectral_pipeline_sharded(torch.zeros(2, 4, 4), mesh=None)


def test_unknown_method_falls_through_to_qr_as_in_jax(symmetric_batch):
    """A method the pipeline does not name takes the QR route in both
    packages (the reference's fall-through)."""
    a, _ = symmetric_batch
    rj = jspec.spectral_pipeline(jnp.asarray(a), iters=60, tol=1e-2,
                                 method="lapack")
    rt = tspec.spectral_pipeline(torch.from_numpy(a), iters=60, tol=1e-2,
                                 method="lapack")
    qr = tspec.spectral_pipeline(torch.from_numpy(a), iters=60, tol=1e-2,
                                 method="qr")
    for f in ("alg_mult", "geom_mult", "diagonalizable"):
        _exact(getattr(rt, f), getattr(rj, f))
    _close(rt.eig_real.numpy(), rj.eig_real)
    _close(rt.D.numpy(), rj.D, rtol=1e-3)
    for f in rt._fields:
        assert torch.equal(getattr(rt, f), getattr(qr, f))
