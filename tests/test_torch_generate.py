"""The port's structured random batches (``linalg_solver_tpu_torch.ops
.generate``) against the JAX package's ``ops.generate``.

The two packages draw from different generators (``torch.Generator``
and ``jax.random``), so the draws are not compared: the port's batches
are held to the properties the reference's are
(``tests/test_ops_eigen.py``: integer ranges, unit determinants, full
rank, exact rank, prescribed spectra), and ``jordan_form_matrix``, which
draws nothing, is compared bit for bit.  Spectra within 1e-3 (float64
``numpy.linalg.eigvals`` of f32 matrices), as the reference's tests."""

import numpy as np
import pytest
import torch

from linalg_solver_tpu.ops import generate as jgen
from linalg_solver_tpu_torch.ops import generate as tgen

CPU = "cpu"


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


@pytest.mark.parametrize("blocks", [
    [(2.0, 3), (5.0, 1), (-1.5, 2)],
    [(0.1, 1), (0.1, 2), (1e-3, 4)],
])
def test_jordan_form_matrix_is_bitwise_the_reference(blocks):
    want = np.asarray(jgen.jordan_form_matrix(blocks))
    got = tgen.jordan_form_matrix(blocks, device=CPU)
    assert got.dtype == torch.float32 and got.device.type == CPU
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_batch_range():
    x = tgen.random_batch(_gen(0), 4, 3, 5, lo=-5, hi=5, device=CPU).numpy()
    assert x.shape == (4, 3, 5) and x.dtype == np.float32
    assert x.min() >= -5 and x.max() <= 5 and (x == np.round(x)).all()
    assert x.min() == -5 and x.max() == 5       # both ends drawn


def test_unimodular_and_full_rank_and_rank():
    P = tgen.unimodular_batch(_gen(1), 8, 4, device=CPU).numpy()
    np.testing.assert_allclose(np.abs(np.linalg.det(P.astype(np.float64))),
                               1.0, atol=1e-6)
    assert (P == np.round(P)).all()
    A = tgen.full_rank_batch(_gen(2), 8, 4, device=CPU).numpy()
    assert (np.abs(np.linalg.det(A.astype(np.float64))) > 0.5).all()
    R = tgen.rank_batch(_gen(3), 6, 4, 5, r=2, device=CPU).numpy()
    assert [np.linalg.matrix_rank(R[i]) for i in range(6)] == [2] * 6


def test_orthogonal_batch_sign_convention():
    """``Q = q·sign(diag r)`` for the QR of the Gaussian the generator
    draws: Q orthogonal and ``Qᵀ G`` upper triangular with a positive
    diagonal (Q unique given G)."""
    Q = tgen.orthogonal_batch(_gen(4), 3, 6, device=CPU).double()
    G = torch.randn(3, 6, 6, generator=_gen(4)).double()
    eye = torch.eye(6, dtype=torch.float64)
    assert float((Q.transpose(1, 2) @ Q - eye).abs().max()) <= 1e-5
    R = Q.transpose(1, 2) @ G
    assert float(torch.tril(R, -1).abs().max()) <= 1e-5
    assert bool((R.diagonal(dim1=1, dim2=2) > 0).all())


@pytest.mark.parametrize("transform", ["unimodular", "orthogonal"])
def test_diagonalizable_batch_eigenvalues(transform):
    A = tgen.diagonalizable_batch(_gen(5), 4, [1.0, 2.0, 3.0],
                                  transform=transform, device=CPU).numpy()
    for i in range(4):
        got = np.sort(np.linalg.eigvals(A[i].astype(np.float64)).real)
        np.testing.assert_allclose(got, [1.0, 2.0, 3.0], atol=1e-3)
    if transform == "unimodular":   # P⁻¹ D P with an integer inverse
        assert (A == np.round(A)).all()
    else:                           # an orthogonal similarity: symmetric
        assert np.abs(A - A.transpose(0, 2, 1)).max() <= 1e-5


def test_jordan_batch_spectrum_and_structure():
    blocks = ((2.0, 2), (5.0, 1))
    A = tgen.jordan_batch(_gen(6), 3, blocks, device=CPU).numpy()
    for i in range(3):
        a = A[i].astype(np.float64)
        got = np.sort(np.linalg.eigvals(a).real)
        np.testing.assert_allclose(got, [2.0, 2.0, 5.0], atol=1e-3)
        # one Jordan block at 2: A − 2I has rank 2, (A − 2I)² rank 1
        m = a - 2.0 * np.eye(3)
        assert np.linalg.matrix_rank(m) == 2
        assert np.linalg.matrix_rank(m @ m) == 1


def test_generators_default_to_the_card():
    """The generators' device defaults to the card: on a machine without
    one the default call fails instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        tgen.random_batch(_gen(0), 2, 2, 2)
