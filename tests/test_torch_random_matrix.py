"""The port's exact random-matrix builders against the JAX package's: for
the same ``random.seed`` every builder mode gives the same matrix, and
leaves the stdlib stream in the same state (the order of draws is part of
the CLI's byte-for-byte contract)."""

import random
from fractions import Fraction

import pytest

import linalg_solver_tpu.exact.random_matrix as jrm
import linalg_solver_tpu_torch.exact.random_matrix as trm

SEEDS = (0, 7, 2026)


def _rows(m):
    return [[Fraction(int(x.p), int(x.q)) if hasattr(x, "q") else
             Fraction(x) for x in row] for row in m.items]


def _same(build, seeds=SEEDS):
    for seed in seeds:
        random.seed(seed)
        want = _rows(build(jrm))
        after = random.random()
        random.seed(seed)
        got = _rows(build(trm))
        assert got == want, seed
        assert random.random() == after, seed


MODES = {
    "raw": lambda m: m.raw_gen_rand_matrix(3, 5),
    "regular": lambda m: m.gen_regular_matrix(4),
    "rank": lambda m: m.gen_matrix_with_rank(3, 4, rank=2),
    "diagonalizable": lambda m: m.gen_diagonalizable_matrix(
        3, eigenvalues=[(5, 1), (2, 1), (-5, 1)]),
    "diagonalizable-drawn": lambda m: m.gen_diagonalizable_matrix(4),
    "jordan-blocks": lambda m: m.gen_matrix_with_jordan_blocks(
        4, [(2, 2), (-1, 1), (3, 1)]),
    "unimodular": lambda m: m.gen_unimodular_matrix(5),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generators_draw_the_same_matrices(mode):
    _same(MODES[mode])


def test_builder_modes_draw_the_same_matrices():
    sparse = lambda: random.randint(-5, 5) if random.random() > 0.45 else 0
    builds = [
        lambda m: m.RandomMatrixBuilder.new().with_dist(sparse)
        .with_size(6, 6).build(),
        lambda m: m.RandomMatrixBuilder().with_rank(3).build_sized(3),
        lambda m: m.RandomMatrixBuilder().with_rank(2).build_sized(3, 5),
        lambda m: m.RandomMatrixBuilder().with_eigenvalues([1, 2, 2])
        .build_sized(3),
        lambda m: m.RandomMatrixBuilder().with_eigenvalues([(0, 2), (3, 1)])
        .build_sized(3),
        lambda m: m.RandomMatrixBuilder().with_jordan_blocks(
            [(1, 3), (-2, 1)]).build_sized(4),
        lambda m: m.RandomMatrixBuilder.new(
            do_randomize_from_diagonal_form=False)
        .with_eigenvalues([4, -1]).build_sized(2),
    ]
    for build in builds:
        _same(build)


def test_jordan_form_and_requirements():
    assert _rows(trm.gen_jordan_matrix(3, [(5, 2), (1, 1)])) == _rows(
        jrm.gen_jordan_matrix(3, [(5, 2), (1, 1)]))
    for mod in (jrm, trm):
        with pytest.raises(ValueError, match="Jordan block sizes"):
            mod.gen_jordan_matrix(3, [(1, 2)])
        with pytest.raises(AssertionError, match="both"):
            mod.RandomMatrixBuilder().with_rank(2).with_eigenvalues(
                [1, 2]).build_sized(2)
        with pytest.raises(AssertionError, match="Rank cannot exceed"):
            mod.RandomMatrixBuilder().with_rank(4).build_sized(3)
