"""The exact-arithmetic ``Matrix`` core (counterpart of
``linalg_solver_tpu.exact.matrix``).

Element-generic matrices over Python lists: entries may be ints, floats,
``fractions.Fraction`` or ``Polynomial``.  Every operation both computes its
result and writes a human-readable LaTeX derivation into the active trace
logger.  ``Fraction`` takes the place of the JAX package's
``sympy.Rational``; an ``int`` divided by an ``int`` becomes a ``float``, as
there (``from_reference_items`` makes exact rows).

The quiet (unlogged) preimage, inverse and rank, which the JAX package
hands to sympy, run the exact elimination (``elimination.row_reduce``) on
the entries as fractions and return what sympy returns: the same
particular solution and generators, the generators in the order of
sympy's parameter names ``tau0, tau1, …`` sorted as strings.

This is the host-side path; the batched device path over CUDA tensors
lives in ``linalg_solver_tpu_torch.ops``, whose ``ops.rref`` events
``trace.events`` replays into the same text.  The eigen methods take the
roots of ``Polynomial.radical_roots``: eigenspaces and diagonalizations
are exact over ℚ and over ℚ(√d) (``Surd`` arithmetic; with eigenvalues
in several fields P⁻¹ is built a field at a time), and a cubic or
binomial radical's geometric multiplicity is a rank over ℚ[t]/(f).
Where sympy's ``simplify`` leaves a quotient (d < 0, several fields) the
port writes the same number in canonical ``p + q·√d`` form.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import itertools
import numbers
from fractions import Fraction

from ..utils.fmt import (
    cformat,
    make_latex_matrix,
    multi_add,
    multi_mul,
)
from ..utils.trace import log, nest_appending_logger
from . import elimination, radicals
from .permutation import Permutation
from .polynomial import LoneRootQuotient, Polynomial
from .radexpr import Radical
from .radicals import Surd


class AffineSubspace:
    """Solution set ``vec + span{columns of generators}``."""

    def __init__(self, vec: List[Any], generators: Optional["Matrix"]):
        self.vec = vec
        self.generators = generators

    def get_one(self) -> List[Any]:
        return self.vec

    def dim(self) -> int:
        if self.generators is None:
            return 0
        return self.generators.cols

    def basis(self) -> List[List[Any]]:
        """Basis of the homogeneous part, one vector per row."""
        if self.generators is None:
            return []
        return self.generators.transpose().items

    def cformat(self, arg_of: str = "") -> str:
        if (
            self.generators is None
            or self.generators.rows == 0
            or self.generators.cols == 0
        ):
            return r" %s " % cformat(Matrix.new_vector(self.vec))
        gens = ", ".join(
            cformat(Matrix.new_vector(self.generators.get_col(i)))
            for i in range(self.generators.cols)
        )
        span = r" \LO \left\{ %s \right\} " % gens
        offset = (
            ""
            if all(v == 0 for v in self.vec)
            else cformat(Matrix.new_vector(self.vec)) + " + "
        )
        return r" %s %s  " % (offset, span)


class NoSolution:
    """Type-level "no solution" marker (instead of an exception)."""

    def __repr__(self) -> str:
        return "NoSolution()"

    def cformat(self, arg_of: str = "") -> str:
        return r"\text{Žádné řešení}"


class DiagonalizationResult:
    """Outcome of ``Matrix.diagonalize``: ``A = P · D · P^{-1}``."""

    def __init__(self, eig_mults, success: bool, P=None, P_inv=None, D=None):
        #: Dict[eigenvalue, (algebraic multiplicity, geometric multiplicity)]
        self.eigenvalue_multiplicities = eig_mults
        self.success = success
        self.P = P
        self.P_inv = P_inv
        self.D = D

    def __repr__(self) -> str:
        return (
            f"DiagonalizationResult(success={self.success}, "
            f"eigenvalue_multiplicities={self.eigenvalue_multiplicities}, "
            f"P={self.P}, P_inv={self.P_inv}, D={self.D})"
        )

    def cformat(self, arg_of: str = "") -> str:
        lines: List[str] = []
        with nest_appending_logger(lines):
            log(
                "Diagonalizace: "
                + ("Úspěšná" if self.success else "Neúspěšná")
            )
            log(r"\[ \begin{array}{|c|c|c|}")
            log(r"\hline")
            log(
                r"\text{Vlastní číslo} & \text{Algebraická násobnost} & "
                r"\text{Geometrická násobnost} \\"
            )
            log(r"\hline")
            for eig, (alg, geom) in self.eigenvalue_multiplicities.items():
                log(r"%s & %s & %s \\", eig, alg, geom)
            log(r"\hline")
            log(r"\end{array} \]")
            if self.success:
                log(r"\[ P = %s \]", self.P)
                log(r"\[ P^{-1} = %s \]", self.P_inv)
                log(r"\[ D = %s \]", self.D)
        return r"\\".join(lines)


class Matrix:
    """Dense exact matrix stored as a list of row lists."""

    # Result types also under the class, as the JAX package has them
    # (``Matrix.NoSolution``, ``Matrix.AffineSubspace``).
    AffineSubspace = AffineSubspace
    NoSolution = NoSolution
    DiagonalizationResult = DiagonalizationResult

    def __init__(self, items: List[List[Any]]):
        if not items:
            raise ValueError("Matrix cannot be empty")
        if not all(isinstance(row, list) for row in items):
            raise ValueError("Matrix items must be a list of lists")
        row_len = len(items[0])
        if row_len == 0:
            if any(row for row in items):
                raise ValueError("Matrix rows cannot be empty if columns exist")
        elif not all(len(row) == row_len for row in items):
            raise ValueError("All matrix rows must have the same length")
        self._cols = row_len
        self.items = items

    # -- shape & access ---------------------------------------------------
    @property
    def rows(self) -> int:
        return len(self.items)

    @property
    def cols(self) -> int:
        return len(self.items[0]) if self.items else self._cols

    def get_row(self, i: int) -> List[Any]:
        return self.items[i]

    def get_col(self, j: int) -> List[Any]:
        return [row[j] for row in self.items]

    def set_item(self, i: int, j: int, value: Any) -> "Matrix":
        self.items[i][j] = value
        return self

    def self_map(self, f: Callable[[Any], Any]) -> "Matrix":
        return Matrix([[f(x) for x in row] for row in self.items])

    def inorder_slot_iter(self) -> Iterator[Tuple[int, int]]:
        for i in range(self.rows):
            for j in range(self.cols):
                yield (i, j)

    def __str__(self) -> str:
        return "\n".join(
            " ".join(str(x) for x in row) for row in self.items
        )

    def cformat(self, _arg_of: str = "") -> str:
        return make_latex_matrix(self.items)

    # -- factories --------------------------------------------------------
    @classmethod
    def zero(cls, rows: int, cols: int) -> "Matrix":
        return cls([[0] * cols for _ in range(rows)])

    @classmethod
    def identity(cls, size: int) -> "Matrix":
        return cls(
            [[1 if i == j else 0 for j in range(size)] for i in range(size)]
        )

    @classmethod
    def diagonal(cls, items: List[Any]) -> "Matrix":
        res = cls.zero(len(items), len(items))
        for i, item in enumerate(items):
            res.items[i][i] = item
        return res

    @classmethod
    def new_vector(cls, items: List[Any]) -> "Matrix":
        return cls([[x] for x in items])

    # -- elementwise arithmetic (logged) ----------------------------------
    def multi_add(self, *others: "Matrix") -> "Matrix":
        operands = [self, *others]
        for i, op in enumerate(operands):
            if op.rows != self.rows or op.cols != self.cols:
                raise ValueError(
                    f"Matrix dimensions must match; mismatch at item {i}"
                )
        res = Matrix.zero(self.rows, self.cols)
        shown = [[""] * self.cols for _ in range(self.rows)]
        sub_logs: List[str] = []
        for i, j in self.inorder_slot_iter():
            with nest_appending_logger(sub_logs):
                shown[i][j] = " + ".join(
                    cformat(op.items[i][j], arg_of="+") for op in operands
                )
                res.items[i][j] = multi_add(
                    [op.items[i][j] for op in operands]
                )
        log(r"$$ %s = %s $$", make_latex_matrix(shown), res)
        if sub_logs:
            log(r"s dílčími kroky: \\")
            for line in sub_logs:
                log(r"%s \\", line)
        return res

    def __add__(self, other: "Matrix") -> "Matrix":
        return self.multi_add(other)

    def scalar_mul(self, scalar: Any) -> "Matrix":
        return Matrix([[x * scalar for x in row] for row in self.items])

    def __neg__(self) -> "Matrix":
        return self.scalar_mul(-1)

    def __sub__(self, other: "Matrix") -> "Matrix":
        return self + (-other)

    def __mul__(self, other: Any) -> "Matrix":
        if not isinstance(other, Matrix):
            return self.scalar_mul(other)
        if self.cols != other.rows:
            raise ValueError("Matrix dimensions must match")
        res = Matrix.zero(self.rows, other.cols)
        shown = [[""] * other.cols for _ in range(self.rows)]
        sub_logs: List[str] = []
        for i in range(self.rows):
            for j in range(other.cols):
                with nest_appending_logger(sub_logs):
                    terms: List[Tuple[str, Any]] = []
                    for k in range(self.cols):
                        a, b = self.items[i][k], other.items[k][j]
                        if a != 0 and b != 0:
                            terms.append((
                                cformat(a, arg_of="*")
                                + r" \cdot "
                                + cformat(b, arg_of="*"),
                                a * b,
                            ))
                    if not terms:
                        shown[i][j] = "0"
                    else:
                        rendered = terms[0][0]
                        for t_str, _ in terms[1:]:
                            # Fold a leading minus into the joining operator.
                            if t_str.strip().startswith("-"):
                                rendered += " - " + t_str.strip()[1:].strip()
                            else:
                                rendered += " + " + t_str
                        shown[i][j] = rendered
                    res.items[i][j] = multi_add(
                        [
                            self.items[i][k] * other.items[k][j]
                            for k in range(self.cols)
                        ]
                    )
        log(
            r"$$ %s \cdot %s = %s = %s $$",
            self,
            other,
            make_latex_matrix(shown),
            res,
        )
        if sub_logs:
            log(r"s dílčími kroky: \\")
            for line in sub_logs:
                log(r"%s \\", line)
        return res

    def transpose(self) -> "Matrix":
        return Matrix(
            [
                [self.items[j][i] for j in range(self.rows)]
                for i in range(self.cols)
            ]
        )

    # -- structure --------------------------------------------------------
    def is_upper_triangular(self) -> bool:
        """True iff every entry STRICTLY ABOVE the diagonal is zero.

        NOTE: the name is swapped relative to the usual math convention
        (it checks ``items[i][j]`` for ``j > i``), and the legacy
        determinant's log labels a zero-upper-triangle matrix "horní";
        the JAX package does the same, and the text must match it."""
        return all(
            self.items[i][j] == 0
            for i in range(self.rows)
            for j in range(i + 1, self.cols)
        )

    def is_lower_triangular(self) -> bool:
        """True iff every entry STRICTLY BELOW the diagonal is zero
        (see the naming note above)."""
        return all(
            self.items[i][j] == 0
            for j in range(self.cols)
            for i in range(j + 1, self.rows)
        )

    def minor(self, i: int, j: int) -> "Matrix":
        return Matrix(
            [
                [x for c, x in enumerate(row) if c != j]
                for r, row in enumerate(self.items)
                if r != i
            ]
        )

    def to_block_matrix(
        self, row_splits: List[int], col_splits: List[int]
    ) -> "Matrix":
        """Split into a matrix of sub-Matrix blocks at the given boundaries."""
        if not all(0 < s < self.rows for s in row_splits):
            raise ValueError(
                "Row splits must be within matrix dimensions "
                "(exclusive of 0 and rows)"
            )
        if not all(0 < s < self.cols for s in col_splits):
            raise ValueError(
                "Column splits must be within matrix dimensions "
                "(exclusive of 0 and cols)"
            )
        rs = sorted(set([0, *row_splits, self.rows]))
        cs = sorted(set([0, *col_splits, self.cols]))
        blocks = []
        for bi in range(len(rs) - 1):
            block_row = []
            for bj in range(len(cs) - 1):
                block_row.append(
                    Matrix(
                        [
                            row[cs[bj]:cs[bj + 1]]
                            for row in self.items[rs[bi]:rs[bi + 1]]
                        ]
                    )
                )
            blocks.append(block_row)
        return Matrix(blocks)

    @classmethod
    def from_block_matrix(
        cls, blocks: "List[List[Matrix]] | Matrix"
    ) -> "Matrix":
        if isinstance(blocks, Matrix):
            blocks = blocks.items
        if not blocks or not blocks[0]:
            return cls([[]])
        n_brow, n_bcol = len(blocks), len(blocks[0])
        if not all(len(row) == n_bcol for row in blocks):
            raise ValueError("All block rows must have the same number of blocks")
        widths = [blocks[0][j].cols for j in range(n_bcol)]
        for i in range(1, n_brow):
            for j in range(n_bcol):
                if blocks[i][j].cols != widths[j]:
                    raise ValueError(
                        f"Inconsistent column width in block column {j}"
                    )
        heights = [blocks[i][0].rows for i in range(n_brow)]
        for i in range(n_brow):
            for j in range(1, n_bcol):
                if blocks[i][j].rows != heights[i]:
                    raise ValueError(
                        f"Inconsistent row height in block row {i}"
                    )
        out: List[List[Any]] = []
        for i in range(n_brow):
            for r in range(heights[i]):
                row: List[Any] = []
                for j in range(n_bcol):
                    row.extend(blocks[i][j].items[r])
                out.append(row)
        return cls(out)

    # -- determinant ------------------------------------------------------
    def determinant(
        self,
        log_permutation_details: bool = False,
        use_optimal: bool = True,
    ) -> Any:
        """Determinant with a logged derivation.

        ``use_optimal=True`` routes through the combinatorial planner
        (``linalg_solver_tpu.planner``) which picks the cheapest strategy for
        the sparsity pattern; ``False`` uses the legacy triangular /
        single-nonzero-expansion / Leibniz path.
        """
        n = self.rows
        if n == 0:
            log(r"$$ \det([]) = 1 $$ ")
            return 1
        if n == 1:
            return self.items[0][0]

        if use_optimal:
            from .determinant_exec import determinant as planned_determinant

            return planned_determinant(self, do_log=True)

        return self._legacy_determinant(log_permutation_details)

    def _legacy_determinant(self, log_permutation_details: bool) -> Any:
        n = self.rows
        kind = ""
        if self.is_upper_triangular():
            kind = "horní"
        elif self.is_lower_triangular():
            kind = "dolní"
        if kind:
            log(
                r"$%s$ je %s trojúhelníková matice, determinant je roven "
                r"součinu diagonálních prvků: ",
                self.cformat(),
                kind,
            )
            diag = [self.items[i][i] for i in range(n)]
            det = multi_mul(diag)
            log(
                r"$$ \det(%s) = %s = %s $$",
                self,
                r"\cdot ".join(cformat(d, arg_of="*") for d in diag),
                det,
            )
            return multi_mul(diag)

        for i in range(n):
            row_nz = [j for j in range(n) if self.items[i][j] != 0]
            col_nz = [j for j in range(n) if self.items[j][i] != 0]
            if not row_nz:
                log(
                    r"%s má nulový %s. řádek, determinant je 0",
                    self.cformat(), i + 1,
                )
                return 0
            if not col_nz:
                log(
                    r"%s má nulový %s. sloupec, determinant je 0",
                    self.cformat(), i + 1,
                )
                return 0
            if len(row_nz) == 1:
                ei, ej = i, row_nz[0]
                log(r"Provedeme rozvoj determinantu podle %s. řádku", i + 1)
            elif len(col_nz) == 1:
                ei, ej = col_nz[0], i
                log(r"Provedeme rozvoj determinantu podle %s. sloupce", i + 1)
            else:
                continue
            sub = self.minor(ei, ej)
            # Recurse through determinant(), not _legacy_determinant():
            # its n==1 short-circuit returns the entry WITHOUT a log line
            # — a 1×1 minor must not emit the triangular-product text.
            sub_det = sub.determinant(log_permutation_details,
                                      use_optimal=False)
            val = (-1) ** (ei + ej) * self.items[ei][ej]
            det = val * sub_det
            log(
                r"$$ \det(%s) = %s \cdot \det(%s) = %s $$",
                self, cformat(val, arg_of="*"), sub, det,
            )
            return det

        return self.direct_determinant(log_permutation_details)

    def direct_determinant(self, log_permutation_details: bool = False) -> Any:
        """Explicit Leibniz sum over all n! permutations."""
        if self.rows != self.cols:
            raise ValueError("Determinant requires a square matrix")
        n = self.rows
        if n == 0:
            log(r"$$ \det([]) = 1 $$ ")
            return 1

        terms: List[Any] = []
        shown_lines: List[str] = []
        for p_tuple in itertools.permutations(range(n)):
            sigma = Permutation(list(p_tuple))
            sign = sigma.sign()
            factors: List[str] = []
            prod_logs: List[str] = []
            term = 1
            with nest_appending_logger(prod_logs):
                for i in range(n):
                    x = self.items[i][sigma(i)]
                    term = term * x
                    factors.append(cformat(x, arg_of="*"))
            value = sign * term
            terms.append(value)

            is_zero_poly = isinstance(value, Polynomial) and all(
                c == 0 for c in value.powers.values()
            )
            if n <= 6 and value != 0 and not is_zero_poly:
                contribution = "%s(%s)" % (
                    "+" if sign == 1 else "-",
                    r"\cdot ".join(factors),
                )
                if log_permutation_details:
                    shown_lines.append(
                        r"%s & \qquad %s \\" % (sigma.cformat(), contribution)
                    )
                else:
                    shown_lines.append(contribution)

        sum_logs: List[str] = []
        with nest_appending_logger(sum_logs):
            total = multi_add(terms)

        if n <= 6:
            prefix = r"$$ \det%s" % self.cformat()
            if log_permutation_details:
                log(r"%s = \begin{aligned}" % prefix)
                log(
                    r"\sigma \in S_{%s} & \qquad \text{sgn}(\sigma) "
                    r"\prod A_{i, \sigma(i)} \\" % n
                )
                log(r"\hline")
                for line in shown_lines:
                    log(line)
                log(r"\end{aligned} $$")
                log(r"$$ = %s $$" % cformat(total))
            else:
                log(
                    r"%s = %s = %s $$ "
                    % (prefix, " ".join(shown_lines), cformat(total))
                )
            if sum_logs:
                log(r"s dílčími kroky sčítání: \\")
                for line in sum_logs:
                    log(r"%s \\", line)
        else:
            log(r"$$ \det(%s) = %s $$ ", self.cformat(), cformat(total))
        return total

    # -- elimination-based operations -------------------------------------
    def row_reduce(self, bar_col: Optional[int] = None):
        """Gauss–Jordan; see ``elimination.row_reduce`` for semantics."""
        return elimination.row_reduce(self.items, bar_col=bar_col)

    def find_preimage_of(
        self,
        vec: List[Any],
        log_matrices: bool = False,
        log_steps: bool = False,
        log_result: bool = False,
    ):
        """Solution set of ``self @ x = vec``: AffineSubspace or NoSolution."""
        if self.rows != len(vec):
            raise ValueError("Matrix dimensions must match")
        if not (log_matrices or log_steps or log_result):
            return _quiet_preimage(self, vec)

        augmented = [row + [vec[i]] for i, row in enumerate(deepcopy(self.items))]
        bar_col = len(augmented[0]) - 1
        reduced, pivots, snapshots, steps = elimination.row_reduce(
            augmented, bar_col=bar_col
        )
        n = bar_col  # number of variables

        elimination.log_row_reduction_progress(
            snapshots, steps, n + 1, log_matrices, log_steps
        )

        result_logs: List[str] = []
        with nest_appending_logger(result_logs):
            if elimination.check_inconsistency(reduced, n, bar_col, log_fn=log):
                return NoSolution()
            particular, gen_columns = elimination.extract_affine_subspace(
                reduced, pivots, n, bar_col, log_fn=log
            )
        if log_result:
            log("\n".join(result_logs))
        gen_mat = Matrix(gen_columns) if gen_columns is not None else None
        return AffineSubspace(particular, gen_mat)

    def kernel(self) -> "AffineSubspace":
        """Nullspace as an AffineSubspace through the origin."""
        return self.find_preimage_of([0] * self.rows)

    def inverse(
        self,
        log_matrices: bool = False,
        log_steps: bool = False,
        log_result: bool = False,
    ):
        """Inverse via ``[A | I]`` reduction, or NoSolution when singular."""
        if self.rows != self.cols:
            raise ValueError("Matrix must be square to invert.")
        n = self.rows
        if not (log_matrices or log_steps or log_result):
            return _quiet_inverse(self)

        ident = Matrix.identity(n)
        augmented = [
            list(self.items[i]) + list(ident.items[i]) for i in range(n)
        ]
        reduced, pivots, snapshots, steps = elimination.row_reduce(
            augmented, bar_col=n
        )
        elimination.log_row_reduction_progress(
            snapshots, steps, 2 * n, log_matrices, log_steps
        )

        result_logs: List[str] = []
        with nest_appending_logger(result_logs):
            ok = all(
                abs(reduced[i][j] - (1 if i == j else 0)) <= 1e-12
                for i in range(n)
                for j in range(n)
            )
            if not ok:
                log(
                    r"\[ \boxed{\text{Matice je singulární: neexistuje "
                    r"inverze.}} \]"
                )
                return NoSolution()
            inv_items = [row[n:] for row in reduced]
            log(
                r"\textbf{Inverzní matice:} \[ %s \]",
                make_latex_matrix(inv_items),
            )
        if log_result:
            log("\n".join(result_logs))
        return Matrix(inv_items)

    def rank(self) -> int:
        """Number of pivots of the exact elimination over fractions."""
        _, pivots, _, _ = elimination.row_reduce(
            _as_fractions(self.items), bar_col=self.cols)
        return len(pivots)

    # -- eigen stack -------------------------------------------------------
    def eigenvalues(self, real_only: bool = False) -> Dict[Any, int]:
        """Eigenvalues with algebraic multiplicities, via the characteristic
        polynomial ``det(A - λI)`` computed by the full determinant machinery
        over ``Polynomial`` entries; the roots are ``radical_roots``'
        (rationals and ``p + q·√d``, in the JAX package's order)."""
        if self.rows != self.cols:
            raise ValueError("Eigenvalues require a square matrix")
        n = self.rows
        lam = Polynomial({1: 1}, var=r"\lambda")
        lam_identity = Matrix.diagonal([lam for _ in range(n)])
        setup_logs: List[str] = []
        with nest_appending_logger(setup_logs):
            char_matrix = self - lam_identity
        log(
            r"Výpočet charakteristické matice $A - \lambda I$: "
            r"$$ A - \lambda I = %s - %s = %s $$",
            self, lam_identity, char_matrix,
        )

        log(r"Výpočet charakteristického polynomu $\det(A - \lambda I)$:")
        char_poly = char_matrix.determinant(log_permutation_details=True)
        log(r"Charakteristický polynom je: $$ p(\lambda) = %s $$", char_poly)

        roots = char_poly.radical_roots()
        if real_only:
            roots = {r: m for r, m in roots.items()
                     if getattr(r, "is_real", True)}
        if roots:
            try:
                factors_dict = char_poly.factor_roots(list(roots.items()))
            except ValueError:
                # as the JAX package: the eigenvalues stand without the
                # factored display
                factors_dict = None
            except LoneRootQuotient:
                # the JAX package writes the EX-domain quotient here, which
                # is not ported (ROADMAP.md queue 1 item 7)
                factors_dict = None
            if factors_dict is not None:
                rendered = []
                for factor, mult in factors_dict.items():
                    if mult == 1:
                        rendered.append(cformat(factor, arg_of="*"))
                    else:
                        rendered.append(
                            r"%s^{%d}" % (cformat(factor, arg_of="^"), mult)
                        )
                log(
                    r"Rozložený tvar: $$ p(\lambda) = %s $$",
                    r" \cdot ".join(rendered),
                )

        summary = ", ".join(
            f"${cformat(r)}$ (multiplicity {m})" for r, m in roots.items()
        )
        field = "R" if real_only else "C"
        log(
            r"Vlastní čísla (kořeny $p(\lambda)$ v $\mathbb{%s}$) s jejich "
            r"algebraickými násobnostmi jsou: %s",
            field, summary,
        )
        return roots

    def find_eigenspace(self, eigenvalue: Any) -> "AffineSubspace":
        """Nullspace of ``A - eigenvalue*I``: exact elimination over ℚ, or
        over ℚ(√d) in ``Surd`` arithmetic for an eigenvalue ``p + q·√d``
        (``sympy.linsolve``'s basis: each free variable 1, in ``tau``
        order).  A cubic or binomial radical's basis is not ported."""
        if self.rows != self.cols:
            raise ValueError("Matrix must be square to find eigenspace.")
        if isinstance(eigenvalue, Radical):
            raise NotImplementedError(
                f"Matrix.find_eigenspace: the eigenspace basis of the "
                f"eigenvalue {cformat(eigenvalue)} is written by sympy's "
                f"linsolve in unsimplified radicals, which is not ported "
                f"(ROADMAP.md queue 1 item 7)")
        shifted = deepcopy(self)
        for i in range(self.rows):
            shifted.items[i][i] = shifted.items[i][i] - eigenvalue
        return Matrix(shifted.items).kernel()

    def eigenvalues_with_geometric_multiplicities(
        self,
    ) -> Dict[Any, Tuple[int, int]]:
        """``{eigenvalue: (algebraic, geometric multiplicity)}``; for a
        root of an irreducible factor f of degree ≥ 3 the geometric
        multiplicity is n − rank(A − tI) over ℚ[t]/(f)."""
        alg_mults = self.eigenvalues()
        out: Dict[Any, Tuple[int, int]] = {}
        for eig, alg in alg_mults.items():
            if isinstance(eig, Radical):
                geom = self.rows - radicals.rank_over_field(
                    self.items, eig.minpoly)
            else:
                space = self.find_eigenspace(eig)
                geom = space.dim() if hasattr(space, "dim") else 0
            out[eig] = (alg, geom)
        return out

    def diagonalize(self) -> "DiagonalizationResult":
        """Attempt ``A = P D P^{-1}``; success iff n independent eigenvectors.

        Over one field (ℚ or one ℚ(√d)) P⁻¹ is Gauss–Jordan in that field;
        with eigenvalues in several fields each row block of P⁻¹ is built
        in its eigenvalue's field from the left eigenvectors."""
        if self.rows != self.cols:
            raise ValueError("Matrix must be square to diagonalize.")
        n = self.rows
        eig_mults = self.eigenvalues_with_geometric_multiplicities()
        if any(isinstance(e, Radical) for e in eig_mults):
            if sum(g for _, g in eig_mults.values()) != n:
                return DiagonalizationResult(eig_mults, False)
            raise NotImplementedError(
                "Matrix.diagonalize: P, P^-1 and D with cubic, quartic or "
                "binomial radical eigenvalues are sympy.simplify forms, "
                "which are not ported (ROADMAP.md queue 1 item 7)")
        blocks: List[Tuple[Any, List[List[Any]]]] = []
        for eig, (alg, geom) in eig_mults.items():
            space = self.find_eigenspace(eig)
            if hasattr(space, "basis"):
                blocks.append((eig, space.basis()))
        basis_vectors = [v for _, vs in blocks for v in vs]
        if len(basis_vectors) != n:
            return DiagonalizationResult(eig_mults, False)
        P = Matrix([list(col) for col in zip(*basis_vectors)])
        fields = {e.d for e in eig_mults if isinstance(e, Surd)}
        if len(fields) <= 1:
            P_inv = P.inverse()
        else:
            P_inv = Matrix(_inverse_by_blocks(self, blocks))
        D = P_inv * self * P
        D.simplify()
        P.simplify()
        P_inv.simplify()
        return DiagonalizationResult(eig_mults, True, P, P_inv, D)

    def simplify(self) -> "Matrix":
        """The JAX package's ``sympy.simplify`` of every entry: the entries
        here (ints, ``Fraction``, floats, ``Polynomial``, ``Surd``) are
        already canonical, so this is the identity (where sympy leaves a
        quotient over ℚ(√d) with d < 0 or over several fields, the port's
        canonical ``p + q·√d`` is the same number)."""
        return self


def from_reference_items(items) -> List[List[Any]]:
    """Exact rows for the port from the rows the JAX package is given:
    an integer (``int`` or numpy) or a ``Fraction`` becomes a ``Fraction``,
    and so does a ``(p, q)`` pair of integers (``p/q``), so that elimination
    divides exactly, as ``sympy.Rational`` does there."""
    out = []
    for row in items:
        exact_row = []
        for x in row:
            if isinstance(x, tuple) and len(x) == 2:
                exact_row.append(Fraction(int(x[0]), int(x[1])))
            elif isinstance(x, numbers.Rational) and not isinstance(x, bool):
                exact_row.append(Fraction(int(x.numerator),
                                          int(x.denominator)))
            else:
                raise TypeError(
                    f"from_reference_items: {x!r} is not an integer, a "
                    f"Fraction or an integer pair (p, q)")
        out.append(exact_row)
    return out


def _as_fractions(items: List[List[Any]]) -> List[List[Any]]:
    """Copies of the rows with integers as ``Fraction`` (what sympy's
    ``Matrix`` makes of them), other entries as they are."""
    return [
        [Fraction(int(x)) if isinstance(x, numbers.Integral) else x
         for x in row]
        for row in items
    ]


def _quiet_preimage(matrix: Matrix, vec: List[Any]):
    """No-log path: the exact elimination of ``[A | b]`` over fractions, as
    ``sympy.linsolve`` solves it, converted into (particular, generators).
    sympy names the free variables' parameters ``tau0, tau1, …`` in column
    order and the JAX package sorts them as strings (``tau10`` before
    ``tau2``), so the generators come in that order."""
    augmented = [row + [vec[i]] for i, row in
                 enumerate(_as_fractions(matrix.items))]
    n = matrix.cols
    reduced, pivots, _, _ = elimination.row_reduce(augmented, bar_col=n)
    if elimination.check_inconsistency(reduced, n, n):
        return NoSolution()
    particular, gen_columns = elimination.extract_affine_subspace(
        reduced, pivots, n, n)
    if gen_columns is None:
        return AffineSubspace(particular, Matrix.zero(n, 0))
    generators = [list(g) for g in zip(*gen_columns)]
    order = sorted(range(len(generators)), key=lambda k: f"tau{k}")
    gen_mat = Matrix([list(col) for col in
                      zip(*(generators[k] for k in order))])
    return AffineSubspace(particular, gen_mat)


def _inverse_by_blocks(matrix: Matrix,
                       blocks: List[Tuple[Any, List[List[Any]]]]
                       ) -> List[List[Any]]:
    """Rows of P⁻¹ for P = [V₁ | V₂ | …] (Vₖ the eigenspace basis of λₖ):
    each block is G⁻¹·W with W the left null basis of A − λₖI and
    G = W·Vₖ, so every product stays in λₖ's field."""
    rows: List[List[Any]] = []
    for eig, vs in blocks:
        shifted = matrix.transpose()
        for i in range(shifted.rows):
            shifted.items[i][i] = shifted.items[i][i] - eig
        W = _quiet_preimage(shifted, [0] * shifted.rows).basis()
        G = [[sum((w[t] * v[t] for t in range(len(w))), 0) for v in vs]
             for w in W]
        G_inv = _quiet_inverse(Matrix(G)).items
        for i in range(len(W)):
            rows.append([
                sum((G_inv[i][k] * W[k][j] for k in range(len(W))), 0)
                for j in range(matrix.cols)])
    return rows


def _quiet_inverse(matrix: Matrix):
    """No-log inverse: ``[A | I]`` reduced exactly over fractions, or
    ``NoSolution`` where A is singular (where sympy's ``inv`` raises)."""
    n = matrix.rows
    augmented = [row + [Fraction(int(i == j)) for j in range(n)]
                 for i, row in enumerate(_as_fractions(matrix.items))]
    reduced, pivots, _, _ = elimination.row_reduce(augmented, bar_col=n)
    if len(pivots) < n:
        return NoSolution()
    return Matrix([row[n:] for row in reduced])
