"""Structured random matrix generation, exact host path (counterpart of
``linalg_solver_tpu.exact.random_matrix``).

Fluent ``RandomMatrixBuilder`` producing matrices that are unconstrained,
full-rank, of prescribed rank r (= A·B with A m×r, B r×n both full rank),
diagonalizable with prescribed eigenvalues (P⁻¹DP), or similar to a
prescribed Jordan form (P⁻¹JP).  Similarity transforms use unimodular
matrices L·U with ±1 diagonals, so P⁻¹ stays integral.

All internal products run under ``ignore_log`` so generation stays silent.

The generation strategies live as module-level functions; the builder is
a thin dispatch over them and the ``gen_*`` conveniences call them
directly.  The ORDER of ``random`` draws inside each strategy is part of
the byte-golden contract with the JAX package's CLI (same seed ⇒ same
matrices ⇒ identical ``output.tex``): row-major entry draws; rejection
loops redraw whole candidates; the unimodular transform draws U before
L, and within each triangular factor the diagonal sign before that
row's off-diagonal entries.  The entries are ints (exact ``Fraction``
after an inverse), and the rejection test is the port's exact ``rank``
(elimination over fractions, where the JAX package asks sympy).

The batched on-device generators live in ``linalg_solver_tpu_torch.ops
.generate``; this module is their exact single-matrix counterpart.
"""

from __future__ import annotations

import random
from typing import Any, Callable, List, Optional, Tuple

from ..utils.trace import ignore_log
from .matrix import Matrix

Dist = Callable[[], Any]


def _default_dist() -> int:
    return random.randint(-5, 5)


# ---------------------------------------------------------------------------
# Generation strategies (module-level; the builder dispatches to these)
# ---------------------------------------------------------------------------

def _draw_items(dist: Dist, rows: int, cols: int) -> List[List[Any]]:
    """Row-major iid draws — one ``dist()`` call per entry, rows outer."""
    return [[dist() for _ in range(cols)] for _ in range(rows)]


def _draw_until_rank(dist: Dist, rows: int, cols: int, target: int) -> Matrix:
    """Rejection sampling: redraw the whole candidate until its exact
    rank (silent) hits ``target``."""
    while True:
        cand = Matrix(_draw_items(dist, rows, cols))
        if cand.rank() == target:
            return cand


def _random_matrix(dist: Dist, rows: int, cols: int) -> Matrix:
    return Matrix(_draw_items(dist, rows, cols))


def _full_rank_matrix(dist: Dist, n: int) -> Matrix:
    return _draw_until_rank(dist, n, n, n)


def _rank_factored_matrix(dist: Dist, rows: int, cols: int,
                          rank: int) -> Matrix:
    """Prescribed rank as a full-rank factorization A(rows×rank)·B(rank×cols);
    A is drawn (and rejection-tested) completely before B."""
    lhs = _draw_until_rank(dist, rows, rank, rank)
    rhs = _draw_until_rank(dist, rank, cols, rank)
    return ignore_log(lambda: lhs * rhs)


def _similar_to(form: Matrix, n: int) -> Matrix:
    """Conjugate ``form`` by a fresh unimodular transform: P⁻¹·form·P
    (P integral with integral inverse, so entries stay exact)."""
    P = gen_unimodular_matrix(n)
    P_inv = P.inverse()
    return ignore_log(lambda: P_inv * form * P)


def _diagonal_form(eig_mults: List[Tuple[Any, int]]) -> Matrix:
    flat: List[Any] = []
    for eig, mult in eig_mults:
        flat.extend([eig] * mult)
    return Matrix.diagonal(flat)


def _jordan_form(n: int, blocks: List[Tuple[Any, int]]) -> Matrix:
    """Block-diagonal Jordan matrix: eigenvalue on the diagonal, ones on
    the first superdiagonal within each block."""
    total = sum(size for _, size in blocks)
    if total != n:
        raise ValueError(
            f"Sum of Jordan block sizes ({total}) must equal matrix "
            f"size ({n})"
        )
    J = [[0] * n for _ in range(n)]
    offset = 0
    for eigenvalue, size in blocks:
        for k in range(offset, offset + size):
            J[k][k] = eigenvalue
            if k + 1 < offset + size:
                J[k][k + 1] = 1
        offset += size
    return Matrix(J)


def _triangular_rows(n: int, dist: Dist, upper: bool) -> List[List[Any]]:
    """One triangular factor of the unimodular transform.  Per row: the
    ±1 diagonal sign is drawn FIRST, then that row's off-diagonal
    entries in ascending column order — the draw order the golden
    contract fixes."""
    rows: List[List[Any]] = []
    for i in range(n):
        diag = random.choice([-1, 1])
        span = range(i + 1, n) if upper else range(i)
        offd = {j: dist() for j in span}
        rows.append(
            [offd[j] if j in offd else (diag if j == i else 0)
             for j in range(n)]
        )
    return rows


# ---------------------------------------------------------------------------
# Fluent builder (thin dispatch over the strategies)
# ---------------------------------------------------------------------------

class RandomMatrixBuilder:
    def __init__(self) -> None:
        self.rank: Optional[int] = None
        self.eigenvalues: Optional[List[Tuple[Any, int]]] = None
        self.jordan_blocks: Optional[List[Tuple[Any, int]]] = None
        self.do_randomize_from_diagonal_form: bool = True
        self.num_rows: Optional[int] = None
        self.num_cols: Optional[int] = None
        self.dist: Optional[Dist] = None

    @classmethod
    def new(cls, **kwargs) -> "RandomMatrixBuilder":
        builder = cls()
        for key, value in kwargs.items():
            setattr(builder, key, value)
        return builder

    # -- fluent configuration ---------------------------------------------
    def with_size(self, num_rows: int, num_cols: int) -> "RandomMatrixBuilder":
        self.num_rows = num_rows
        self.num_cols = num_cols
        return self

    def with_rank(self, rank: int) -> "RandomMatrixBuilder":
        self.rank = rank
        return self

    def with_dist(self, dist: Optional[Dist]) -> "RandomMatrixBuilder":
        self.dist = dist
        return self

    def with_eigenvalues(self, eigenvalues) -> "RandomMatrixBuilder":
        first = eigenvalues[0]
        self.eigenvalues = (
            list(eigenvalues)
            if isinstance(first, tuple)
            else [(e, 1) for e in eigenvalues]
        )
        return self

    def with_jordan_blocks(
        self, blocks: List[Tuple[Any, int]]
    ) -> "RandomMatrixBuilder":
        self.jordan_blocks = blocks
        return self

    # -- validation --------------------------------------------------------
    def is_square(self) -> bool:
        return self.num_rows == self.num_cols

    def _structured_modes(self) -> List[str]:
        """Names of the mutually-exclusive structure requests set."""
        return [
            name
            for name in ("eigenvalues", "rank", "jordan_blocks")
            if getattr(self, name) is not None
        ]

    def assert_requirements(self) -> None:
        modes = self._structured_modes()
        pretty = {
            "eigenvalues": "eigenvalues",
            "rank": "rank",
            "jordan_blocks": "Jordan blocks",
        }
        for a in modes:
            for b in modes:
                assert a == b, (
                    f"Cannot specify both {pretty[a]} and {pretty[b]}."
                )
        if "eigenvalues" in modes:
            assert self.is_square(), "Diagonalizable matrix must be square."
            assert sum(m for _, m in self.eigenvalues) == self.num_rows, (
                "Sum of eigenvalue multiplicities must match matrix size."
            )
        if "rank" in modes:
            assert self.rank <= min(self.num_rows, self.num_cols), (
                "Rank cannot exceed min(num_rows, num_cols)."
            )
        if "jordan_blocks" in modes:
            assert self.is_square(), "Jordan block matrix must be square."
            assert sum(s for _, s in self.jordan_blocks) == self.num_rows, (
                "Sum of Jordan block sizes must match matrix size."
            )

    # -- build dispatch ----------------------------------------------------
    def build_sized(self, num_rows: int, num_cols: Optional[int] = None) -> Matrix:
        self.num_rows = num_rows
        self.num_cols = num_cols if num_cols is not None else num_rows
        return self.build()

    def build(self) -> Matrix:
        self.assert_requirements()
        mode = (self._structured_modes() or ["random"])[0]
        if mode == "jordan_blocks":
            return self.build_jordanized()
        if mode == "eigenvalues":
            return self.build_diagonalizable()
        if mode == "rank":
            square = self.num_rows == self.num_cols
            if square and self.rank == self.num_rows:
                return self.build_full_rank()
            return self.build_rank()
        return self.build_random()

    # -- strategies (delegate to the module-level implementations) ---------
    def build_random(self) -> Matrix:
        return _random_matrix(
            self.dist or _default_dist, self.num_rows, self.num_cols
        )

    def build_full_rank(self) -> Matrix:
        return _full_rank_matrix(self.dist or _default_dist, self.num_rows)

    def build_rank(self) -> Matrix:
        return _rank_factored_matrix(
            self.dist or _default_dist,
            self.num_rows, self.num_cols, self.rank,
        )

    def build_diagonalizable(self) -> Matrix:
        D = _diagonal_form(self.eigenvalues)
        if not self.do_randomize_from_diagonal_form:
            return D
        return _similar_to(D, self.num_rows)

    def build_jordan(self) -> Matrix:
        return _jordan_form(self.num_rows, self.jordan_blocks)

    def build_jordanized(self) -> Matrix:
        return _similar_to(self.build_jordan(), self.num_rows)


# ---------------------------------------------------------------------------
# Convenience generators (call the strategies directly; like the JAX
# package's, they do NOT run assert_requirements)
# ---------------------------------------------------------------------------

def raw_gen_rand_matrix(
    rows: int, cols: int, dist: Optional[Dist] = None
) -> Matrix:
    return _random_matrix(dist or _default_dist, rows, cols)


def gen_regular_matrix(N: int, dist: Optional[Dist] = None) -> Matrix:
    return _full_rank_matrix(dist or _default_dist, N)


def gen_matrix_with_rank(
    rows: int, cols: int, rank: Optional[int] = None,
    dist: Optional[Dist] = None,
) -> Matrix:
    return _rank_factored_matrix(
        dist or _default_dist, rows, cols, rank or min(rows, cols)
    )


def gen_jordan_matrix(N: int, blocks: List[Tuple[Any, int]]) -> Matrix:
    return _jordan_form(N, blocks)


def gen_matrix_with_jordan_blocks(
    N: int, blocks: List[Tuple[Any, int]], dist: Optional[Dist] = None
) -> Matrix:
    return _similar_to(_jordan_form(N, blocks), N)


def gen_diagonalizable_matrix(
    N: int,
    eigenvalues: Optional[List[Tuple[Any, int]]] = None,
    dist: Optional[Dist] = None,
) -> Matrix:
    if eigenvalues is None:
        draw = dist if dist is not None else _default_dist
        eigenvalues = [(draw(), 1) for _ in range(N)]
    return _similar_to(_diagonal_form(eigenvalues), N)


def gen_unimodular_matrix(N: int, dist: Optional[Dist] = None) -> Matrix:
    """L·U with ±1 diagonal entries: det = ±1, hence an exact integer
    inverse — the similarity transform used by the structured builders.
    Draw order (golden contract): U's rows first, then L's."""
    if dist is None:
        dist = lambda: random.randint(-1, 1)  # noqa: E731
    U = Matrix(_triangular_rows(N, dist, upper=True))
    L = Matrix(_triangular_rows(N, dist, upper=False))
    return ignore_log(lambda: L * U)
