"""The spectral pipeline's Schur-method refusals, its core and QR route and
the Jordan analysis against the JAX package.  Split from
``tests/test_torch_spectral.py`` (its helpers and tolerances)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linalg_solver_tpu.models import jordan as jjor
from linalg_solver_tpu.models import spectral as jspec
from linalg_solver_tpu_torch.models import jordan as tjor
from linalg_solver_tpu_torch.models import spectral as tspec

from test_torch_spectral import (EIGS, _close, _exact, jordan_batch,
                                 nonsymmetric_batch, symmetric_batch)


@pytest.mark.parametrize("method", ["gj", "svd"])
def test_jordan_analysis_matches_jax(jordan_batch, method):
    a = jordan_batch
    rj = jjor.jordan_analysis(jnp.asarray(a), jnp.asarray(EIGS), k_max=4,
                              method=method)
    rt = tjor.jordan_analysis(torch.from_numpy(a), EIGS, k_max=4,
                              method=method)
    for f in rj._fields:
        _exact(getattr(rt, f), getattr(rj, f))
    assert rt.weyr[0].tolist() == [[3, 2, 1, 0], [2, 2, 0, 0], [1, 0, 0, 0]]
    assert rt.alg_mult.tolist() == [[6, 4, 1]] * 3
    assert rt.block_counts[0, 0].tolist() == [1, 1, 1, 0]


def test_jordan_null_bases_match_jax(jordan_batch):
    """One deflation step's null bases: the gj path's orthonormalized
    generators value for value; the SVD's as projectors ``Q Qᵀ`` (the
    singular vectors' signs are the library's)."""
    a = jordan_batch
    M = a - 2.0 * np.eye(a.shape[-1], dtype=np.float32)
    tol = 100 * a.shape[-1] * np.finfo(np.float32).eps * np.abs(M).max(
        axis=(1, 2))
    tol = tol.astype(np.float32)
    for jf, tf in ((jjor._nullspace_gj, tjor._nullspace_gj),
                   (jjor._nullspace_svd, tjor._nullspace_svd)):
        qj, dj = jf(jnp.asarray(M), jnp.asarray(tol))
        qt, dt = tf(torch.from_numpy(M), torch.from_numpy(tol))
        _exact(dt, dj)
        assert dt.tolist() == [3, 3, 3]
        if jf is jjor._nullspace_gj:
            _close(qt.numpy(), qj)
        qj = np.asarray(qj, np.float64)
        qt = qt.numpy().astype(np.float64)
        _close(qt @ qt.transpose(0, 2, 1), qj @ qj.transpose(0, 2, 1))


def test_spectral_core_and_qr_pipeline_match_jax(symmetric_batch):
    """The spectral core on given eigenvalues (kernel 3's plain version
    against the reference's loop), and the QR route end to end."""
    a, eigs = symmetric_batch
    ev = np.tile(np.sort(np.array(eigs, np.float32)), (3, 1))
    zeros = np.zeros_like(ev)
    rj = jspec._spectral_core(jnp.asarray(a), jnp.asarray(ev),
                              jnp.asarray(zeros), 1e-2)
    rt = tspec._spectral_core(torch.from_numpy(a), torch.from_numpy(ev),
                              torch.from_numpy(zeros), 1e-2)
    for f in ("alg_mult", "geom_mult", "diagonalizable", "eig_real"):
        _exact(getattr(rt, f), getattr(rj, f))
    for f in ("P", "P_inv", "D"):
        _close(getattr(rt, f).numpy(), getattr(rj, f))
    rj = jspec.spectral_pipeline(jnp.asarray(a), iters=60, tol=1e-2,
                                 method="qr")
    rt = tspec.spectral_pipeline(torch.from_numpy(a), iters=60, tol=1e-2,
                                 method="qr")
    for f in ("alg_mult", "geom_mult", "diagonalizable"):
        _exact(getattr(rt, f), getattr(rj, f))
    assert rt.diagonalizable.tolist() == [True] * 3
    _close(rt.eig_real.numpy(), rj.eig_real)
    _close(rt.D.numpy(), rj.D, rtol=1e-3)


@pytest.mark.parametrize("method", ["schur", "eig", "auto"])
def test_schur_methods_raise_naming_what_is_missing(nonsymmetric_batch,
                                                    method):
    """The reference's default, its eigenvector method and ``auto`` on a
    non-symmetric batch (which takes the Schur route) run on
    ``ops.schur`` and report what the JAX package reports: multiplicities
    and ``diagonalizable`` equal, eigenvalues and D within 1e-4."""
    a = nonsymmetric_batch
    rj = jspec.spectral_pipeline(jnp.asarray(a), tol=1e-2, method=method)
    rt = tspec.spectral_pipeline(torch.from_numpy(a), tol=1e-2,
                                 method=method)
    for f in ("alg_mult", "geom_mult", "diagonalizable"):
        _exact(getattr(rt, f), getattr(rj, f))
    for f in ("eig_real", "eig_imag", "D"):
        _close(getattr(rt, f).numpy(), getattr(rj, f))
    assert rt.diagonalizable.tolist() == [True] * 4
    assert rt.alg_mult[0].tolist() == [4] * 16
    assert rt.alg_mult[2].tolist() == [1] * 16
