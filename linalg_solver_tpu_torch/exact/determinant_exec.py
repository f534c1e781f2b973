"""Executor for planner-produced determinant strategies (counterpart of
``linalg_solver_tpu.exact.determinant_exec``).

The planner (``linalg_solver_tpu_torch.planner``) works on sparsity
patterns only; this module interprets the resulting ``Process`` tree on the
actual matrix values, logging every step as LaTeX.  Index mappings
(``rows``, ``cols`` lists) realize submatrices as views — no data is
copied except for the AddRow row modification.

Sparsity contract: the actual matrix may be *sparser* than the plan
expects (extra zeros are fine) but a nonzero where the plan expects a zero
is an error — checked before executing each node, and after applying each
AddRow transformation.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Optional, Sequence, Tuple

from ..planner import (
    AddRow,
    BlockTriangular,
    ColExpansion,
    Cost,
    Direct,
    Process,
    RowExpansion,
    find_optimal_determinant_process,
)
from ..utils.fmt import cformat, make_latex_matrix, multi_add, multi_mul, pcformat
from ..utils.trace import log
from . import nroots
from .permutation import Permutation, RowColPermutation
from .polynomial import Polynomial


def matrix_to_sparsity_pattern(matrix) -> List[List[bool]]:
    """Boolean nonzero pattern of a Matrix for the planner."""
    return [[item != 0 for item in row] for row in matrix.items]


def find_optimal_process(matrix) -> Tuple[Cost, Process]:
    result = find_optimal_determinant_process(
        matrix_to_sparsity_pattern(matrix)
    )
    return result.cost, result.process


def check_sparsity(
    matrix,
    expected_nonzeros: Sequence[Tuple[int, int]],
    rows: List[int],
    cols: List[int],
) -> None:
    """Raise ValueError if the matrix has a nonzero where the plan expects 0."""
    expected = set(expected_nonzeros)
    for lr in range(len(rows)):
        for lc in range(len(cols)):
            value = matrix.items[rows[lr]][cols[lc]]
            if value != 0 and (lr, lc) not in expected:
                raise ValueError(
                    r"Sparsity mismatch: matrix has non-zero at position "
                    r"(%s, %s) (local (%s, %s)) but the process expects zero "
                    r"there. Expected non-zeros: %s"
                    % (rows[lr], cols[lc], lr, lc, sorted(expected))
                )


class _RowView:
    """Lightweight matrix-shaped wrapper over modified row data."""

    __slots__ = ("items", "rows", "cols")

    def __init__(self, items: List[List[Any]]):
        self.items = items
        self.rows = len(items)
        self.cols = len(items[0]) if items else 0


def _at(matrix, rows: List[int], cols: List[int], i: int, j: int) -> Any:
    return matrix.items[rows[i]][cols[j]]


def _view_items(matrix, rows: List[int], cols: List[int]) -> List[List[Any]]:
    return [
        [matrix.items[r][c] for c in cols] for r in rows
    ]


def execute_process(
    matrix,
    process: Process,
    rows: Optional[List[int]] = None,
    cols: Optional[List[int]] = None,
    do_log: bool = False,
    sign: int = 1,
) -> Any:
    """Run a determinant strategy on actual values; returns the determinant."""
    if rows is None:
        rows = list(range(matrix.rows))
    if cols is None:
        cols = list(range(matrix.rows))

    raw = process.raw
    # AddRow's expected_nonzeros describe the *result* of the transformation;
    # its executor validates after applying the row operation instead.
    if not isinstance(raw, AddRow):
        check_sparsity(matrix, process.expected_nonzeros.entries(), rows, cols)

    if isinstance(raw, Direct):
        return _exec_direct(matrix, raw, rows, cols, do_log, sign)
    if isinstance(raw, RowExpansion):
        return _exec_row_expansion(matrix, raw, rows, cols, do_log, sign)
    if isinstance(raw, ColExpansion):
        return _exec_col_expansion(matrix, raw, rows, cols, do_log, sign)
    if isinstance(raw, BlockTriangular):
        return _exec_block_triangular(matrix, raw, rows, cols, do_log, sign)
    if isinstance(raw, AddRow):
        return _exec_add_row(matrix, raw, rows, cols, do_log, sign)
    raise ValueError(f"Unknown process type: {type(raw).__name__}")


# ---------------------------------------------------------------------------
# Direct (n <= 2 closed form; Leibniz fallback)
# ---------------------------------------------------------------------------

def _exec_direct(matrix, raw: Direct, rows, cols, do_log, sign) -> Any:
    n = len(rows)
    if n == 0:
        if do_log:
            log(r"$\det([]) = 1$")
        return sign * 1
    if n == 1:
        # 1x1 determinants are trivial; not worth a log line.
        return sign * _at(matrix, rows, cols, 0, 0)
    if n == 2:
        a = _at(matrix, rows, cols, 0, 0)
        b = _at(matrix, rows, cols, 0, 1)
        c = _at(matrix, rows, cols, 1, 0)
        d = _at(matrix, rows, cols, 1, 1)
        result = sign * (a * d - b * c)
        if do_log:
            def paren_if_negative(v: Any) -> str:
                s = cformat(v, arg_of="*")
                if str(s).strip().startswith("-"):
                    return r"\left(%s\right)" % s
                return s

            log(
                r"$$ \det%s = %s \cdot %s - %s \cdot %s = %s $$",
                make_latex_matrix(_view_items(matrix, rows, cols)),
                cformat(a, arg_of="*"),
                cformat(d, arg_of="*"),
                paren_if_negative(b),
                paren_if_negative(c),
                cformat(result),
            )
        return result

    # Leibniz fallback for larger Direct nodes (planner normally avoids this).
    import itertools

    terms = []
    for p_tuple in itertools.permutations(range(n)):
        sigma = Permutation(list(p_tuple))
        term = 1
        for i in range(n):
            term = term * _at(matrix, rows, cols, i, p_tuple[i])
        terms.append(sigma.sign() * term)
    return sign * multi_add(terms)


# ---------------------------------------------------------------------------
# Laplace expansions
# ---------------------------------------------------------------------------

def _exec_expansion(
    matrix, rows, cols, do_log, sign,
    axis: str, index: int, minors: List[Tuple[int, Process]],
) -> Any:
    """Shared row/column Laplace expansion executor.

    ``axis`` is "row" or "col"; ``index`` the expanded line; ``minors`` maps
    the crossing index to the subprocess for that minor.
    """
    if do_log:
        czech_axis = "řádku" if axis == "row" else "sloupce"
        log(
            r"Provedeme rozvoj determinantu podle %s. %s:",
            index + 1, czech_axis,
        )
        log(r"$$ \det%s $$", make_latex_matrix(_view_items(matrix, rows, cols)))

    if not minors:
        if do_log:
            if axis == "row":
                log(r"Řádek %s je nulový, determinant je 0.", index + 1)
            else:
                log(r"Sloupec %s je nulový, determinant je 0.", index + 1)
        return 0

    terms = []
    term_strs = []
    if axis == "row":
        remaining_rows_base = [r for i, r in enumerate(rows) if i != index]
    else:
        remaining_cols_base = [c for i, c in enumerate(cols) if i != index]

    for crossing, subprocess in minors:
        if axis == "row":
            i_idx, j_idx = index, crossing
            sub_rows = remaining_rows_base
            sub_cols = [c for i, c in enumerate(cols) if i != crossing]
        else:
            i_idx, j_idx = crossing, index
            sub_rows = [r for i, r in enumerate(rows) if i != crossing]
            sub_cols = remaining_cols_base

        element = _at(matrix, rows, cols, i_idx, j_idx)
        if element == 0:
            continue  # sparser than planned: term vanishes

        cofactor_sign = (-1) ** (i_idx + j_idx)
        minor_det = execute_process(
            matrix, subprocess, sub_rows, sub_cols, do_log=do_log
        )
        term = cofactor_sign * element * minor_det
        terms.append(term)

        if do_log:
            log(
                r"$$ (-1)^{%s+%s} \cdot a_{%s,%s} \cdot M_{%s,%s} = "
                r"%s \cdot %s \cdot \det%s = %s \cdot %s = %s $$",
                i_idx + 1, j_idx + 1,
                i_idx + 1, j_idx + 1,
                i_idx + 1, j_idx + 1,
                "+" if cofactor_sign > 0 else "-",
                cformat(element, arg_of="*"),
                make_latex_matrix(_view_items(matrix, sub_rows, sub_cols)),
                cformat(element, arg_of="*"),
                cformat(minor_det, arg_of="*"),
                cformat(term),
            )
            term_strs.append(cformat(term, arg_of="+"))

    if not terms:
        return 0
    result = sign * multi_add(terms)
    if do_log:
        log(r"$$ \det = %s = %s $$", " + ".join(term_strs), cformat(result))
    return result


def _exec_row_expansion(matrix, raw: RowExpansion, rows, cols, do_log, sign):
    return _exec_expansion(
        matrix, rows, cols, do_log, sign, "row", raw.row, raw.minors
    )


def _exec_col_expansion(matrix, raw: ColExpansion, rows, cols, do_log, sign):
    return _exec_expansion(
        matrix, rows, cols, do_log, sign, "col", raw.col, raw.minors
    )


# ---------------------------------------------------------------------------
# Block triangular
# ---------------------------------------------------------------------------

def czech_enumeration_join(parts: List[str]) -> str:
    if not parts:
        return ""
    if len(parts) == 1:
        return parts[0]
    return ", ".join(parts[:-1]) + " a " + parts[-1]


def _exec_block_triangular(matrix, raw: BlockTriangular, rows, cols, do_log, sign):
    row_perm = raw.row_perm.perm
    col_perm = raw.col_perm.perm

    rc = RowColPermutation(row_perm, col_perm)
    perm, used_reversal = rc.try_transpose()
    rp, cp = perm.to_rows_cols_permutations()
    perm_sign = rp.sign() * cp.sign()

    actual_row_perm = [rows[i] for i in row_perm]
    actual_col_perm = [cols[i] for i in col_perm]

    if do_log:
        steps = []
        if used_reversal:
            # Simultaneous reversal of row and column order — a cost trick,
            # not a mathematical transpose.
            steps.append("současným obrácením pořadí řádků i sloupců")
        if not rp.is_id():
            transpose = rp.try_get_one_transpose()
            if transpose:
                steps.append(pcformat(
                    "prohozením řádků $%s$ a $%s$",
                    transpose[0] + 1, transpose[1] + 1,
                ))
            else:
                steps.append(pcformat("permutací řádků $%s$", rp))
        if not cp.is_id():
            transpose = cp.try_get_one_transpose()
            if transpose:
                steps.append(pcformat(
                    "prohozením sloupců  $%s$ a $%s$",
                    transpose[0] + 1, transpose[1] + 1,
                ))
            else:
                steps.append(pcformat("permutací sloupců  $%s$", cp))

        all_scalar_blocks = all(b.size == 1 for b in raw.blocks)
        shape = (
            "horního trojúhelníkového"
            if all_scalar_blocks
            else "horního blokově trojúhelníkového"
        )
        steps_str = czech_enumeration_join(steps)
        if steps_str:
            log("Matici %s převedeme do %s tvaru:", steps_str, shape)
        else:
            log("Matici převedeme do %s tvaru:", shape)

        log(
            r"$$ %s $$",
            make_latex_matrix(
                _view_items(matrix, actual_row_perm, actual_col_perm)
            ),
        )
        # B = P A Q  =>  det(A) = det(P) det(Q) det(B).
        if perm_sign == -1:
            log(
                r"Permutace řádků a sloupců změní determinant znaménkem: "
                r"$\det(A) = -\det(B)$."
            )
        else:
            log(
                r"Permutace řádků a sloupců determinant nemění: "
                r"$\det(A) = \det(B)$."
            )
        log(r"V blokově trojúhelníkovém tvaru platí $\det(B)=\prod \det(B_i)$.")

    block_dets = []
    offset = 0
    for i, block_process in enumerate(raw.blocks):
        size = block_process.size
        block_rows = actual_row_perm[offset:offset + size]
        block_cols = actual_col_perm[offset:offset + size]
        log_block = do_log and size > 1
        if log_block:
            log(r"Blok $B_{%s}$:", i + 1)
            log(
                r"$$ B_{%s} = %s $$",
                i + 1,
                make_latex_matrix(_view_items(matrix, block_rows, block_cols)),
            )
        det = execute_process(
            matrix, block_process, block_rows, block_cols, do_log=log_block
        )
        block_dets.append(det)
        if log_block:
            log(r"$$ \det(B_{%s}) = %s $$", i + 1, cformat(det))
        offset += size

    result = sign * perm_sign * multi_mul(block_dets)
    if do_log:
        log(
            r"$$ \det = \prod_{i=1}^{%s} \det(B_i) = %s = %s $$",
            len(raw.blocks),
            r" \cdot ".join(cformat(d, arg_of="*") for d in block_dets),
            cformat(result),
        )
    return result


# ---------------------------------------------------------------------------
# AddRow (fraction-free for polynomial entries)
# ---------------------------------------------------------------------------

def polynomial_safe_divide(numerator: Any, denominator: Any) -> Any:
    """Exact quotient of the fraction-free AddRow: long division of
    ``Polynomial`` values (raises where it leaves a remainder), or where
    the coefficients are rational and float, the JAX package's
    ``sympy.cancel`` over RR (``nroots.cancel_quotient``, ``Float``
    coefficients); a quotient of degree 0 comes back as its coefficient."""
    var = r"\lambda"
    if isinstance(numerator, Polynomial):
        var = numerator.var
    elif isinstance(denominator, Polynomial):
        var = denominator.var
    if not isinstance(numerator, Polynomial):
        numerator = Polynomial({0: numerator}, var)
    den = denominator if isinstance(denominator, Polynomial) \
        else Polynomial({0: denominator}, var)
    coeffs = list(numerator.powers.values()) + list(den.powers.values())
    if not nroots.is_real_float(coeffs):
        quotient, remainder = numerator.div_rem(den)
    else:
        # a float coefficient: sympy.cancel over RR, as the JAX package
        # takes it (a remainder leaves it a rational function)
        powers = nroots.cancel_quotient(numerator.powers, den.powers)
        quotient = Polynomial(powers or {}, var)
        remainder = numerator if powers is None else Polynomial({}, var)
    if remainder.powers:
        raise ValueError(
            f"AddRow: {cformat(numerator)} is not divisible by "
            f"{cformat(denominator)} (remainder {cformat(remainder)})"
        )
    if set(quotient.powers) <= {0}:
        return quotient.powers.get(0, 0)
    return quotient


def _exec_add_row(matrix, raw: AddRow, rows, cols, do_log, sign):
    src, dst, pivot_col = raw.src, raw.dst, raw.pivot_col
    src_pivot = _at(matrix, rows, cols, src, pivot_col)
    dst_pivot = _at(matrix, rows, cols, dst, pivot_col)
    if src_pivot == 0:
        raise ValueError("AddRow: source pivot is zero")

    fraction_free = isinstance(src_pivot, Polynomial) or isinstance(
        dst_pivot, Polynomial
    )

    modified_items = deepcopy(matrix.items)
    n_cols = len(cols)

    if do_log:
        log(r"Úprava matice řádkovými operacemi:")
        log(r"$$ %s $$", make_latex_matrix(_view_items(matrix, rows, cols)))

    if fraction_free:
        # dst' = src_pivot*dst - dst_pivot*src: no division inside the ring;
        # the determinant picks up a factor of src_pivot, divided out at the
        # end via exact cancellation.
        if do_log:
            log(
                r"Eliminace ve sloupci %s: $R_{%s} \leftarrow %s \cdot "
                r"R_{%s} - %s \cdot R_{%s}$",
                pivot_col + 1,
                dst + 1,
                cformat(src_pivot, arg_of="*"),
                dst + 1,
                cformat(dst_pivot, arg_of="*"),
                src + 1,
            )
        for j in range(n_cols):
            s_val = matrix.items[rows[src]][cols[j]]
            d_val = matrix.items[rows[dst]][cols[j]]
            modified_items[rows[dst]][cols[j]] = (
                src_pivot * d_val - dst_pivot * s_val
            )
        modified = _RowView(modified_items)

        if do_log:
            log(r"Po úpravě:")
            log(r"$$ %s $$", make_latex_matrix(_view_items(modified, rows, cols)))

        check_sparsity(
            modified, raw.result.expected_nonzeros.entries(), rows, cols
        )
        sub_det = execute_process(modified, raw.result, rows, cols, do_log, sign)

        if do_log:
            log(
                r"Dělíme výsledek faktorem $%s$ z úpravy řádku.",
                cformat(src_pivot),
            )
        return polynomial_safe_divide(sub_det, src_pivot)

    scalar = -dst_pivot / src_pivot
    if do_log:
        log(
            r"Přičteme $%s$-násobek řádku %s k řádku %s (eliminace ve "
            r"sloupci %s):",
            cformat(scalar), src + 1, dst + 1, pivot_col + 1,
        )
    for j in range(n_cols):
        s_val = matrix.items[rows[src]][cols[j]]
        d_val = matrix.items[rows[dst]][cols[j]]
        modified_items[rows[dst]][cols[j]] = d_val + scalar * s_val
    modified = _RowView(modified_items)

    if do_log:
        log(r"Po úpravě:")
        log(r"$$ %s $$", make_latex_matrix(_view_items(modified, rows, cols)))

    check_sparsity(
        modified, raw.result.expected_nonzeros.entries(), rows, cols
    )
    return execute_process(modified, raw.result, rows, cols, do_log, sign)


# ---------------------------------------------------------------------------
# Top-level entry
# ---------------------------------------------------------------------------

def determinant(matrix, do_log: bool = True) -> Any:
    """Plan and execute the optimal determinant strategy for ``matrix``."""
    if matrix.rows != matrix.cols:
        raise ValueError("Determinant requires a square matrix")
    n = matrix.rows
    if n == 0:
        if do_log:
            log(r"$\det([]) = 1$")
        return 1

    if do_log:
        log(r"Výpočet determinantu matice:")
        log(r"$$ \det%s $$", make_latex_matrix(matrix.items))

    cost, process = find_optimal_process(matrix)

    if do_log:
        log(
            r"Optimální strategie: %s operací (%s násobení, %s sčítání)",
            cost.total, cost.multiplications, cost.additions,
        )

    return execute_process(matrix, process, do_log=do_log)
