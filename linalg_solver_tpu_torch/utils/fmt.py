"""LaTeX rendering layer (counterpart of ``linalg_solver_tpu.utils.fmt``).

Every value that flows through the exact path renders to LaTeX via
``cformat(value, arg_of)``.  Custom types participate by exposing a
``cformat(self, arg_of)`` method (duck-typed protocol); ``arg_of`` is the
surrounding operator context (``"+"``, ``"*"``, ``"^"`` or ``None``) and
controls parenthesization.  Scalars (``int``, ``fractions.Fraction``,
``float``) go through ``latex_scalar``, which writes what the JAX
package's ``sympy.latex`` writes for the same value, so the port makes
the same text without sympy.

Also provides the pmatrix/array builders used for matrices, vectors and
augmented matrices, and the generic ``multi_add``/``multi_mul`` reduction
helpers that respect element types which define their own n-ary operations.
"""

from __future__ import annotations

import math
import numbers
from fractions import Fraction
from typing import Any, List, Optional, Sequence


# ---------------------------------------------------------------------------
# Scalar rendering
# ---------------------------------------------------------------------------

#: significant digits of a float, as sympy prints a 53-bit ``Float``
_FLOAT_DIGITS = 15


def _latex_float(x: float) -> str:
    """``sympy.latex(x)`` of a Python float: 15 significant digits rounded
    half up from the exact binary value, trailing zeros stripped (one kept
    after the point), fixed notation for decimal exponents -4 … 14, else
    ``m \\cdot 10^{e}``."""
    if math.isnan(x):
        return r"\text{NaN}"
    if math.isinf(x):
        return r"\infty" if x > 0 else r"-\infty"
    if x == 0:
        return "0.0"
    sign = "-" if x < 0 else ""
    f = Fraction(abs(x))
    e = math.floor(math.log10(abs(x)))
    while f >= Fraction(10) ** (e + 1):
        e += 1
    while f < Fraction(10) ** e:
        e -= 1
    scaled = f / Fraction(10) ** (e - _FLOAT_DIGITS + 1)
    digits = math.floor(scaled)
    if scaled - digits >= Fraction(1, 2):
        digits += 1
    if digits == 10 ** _FLOAT_DIGITS:
        digits //= 10
        e += 1
    text = str(digits)
    if -5 < e < _FLOAT_DIGITS:
        if e < 0:
            text, split = "0" * -e + text, 1
        else:
            split = e + 1
        exponent = None
    else:
        split, exponent = 1, e
    text = (text[:split] + "." + text[split:]).rstrip("0")
    if text.endswith("."):
        text += "0"
    if exponent is None:
        return sign + text
    return r"%s%s \cdot 10^{%d}" % (sign, text, exponent)


def latex_scalar(val: Any) -> str:
    """LaTeX of a number as ``sympy.latex`` writes it: an integer in full,
    a fraction as ``\\frac{p}{q}`` (``- \\frac{p}{q}`` when negative; an
    integer when q = 1), a float as ``_latex_float``."""
    if isinstance(val, bool):
        return r"\text{%s}" % val
    if isinstance(val, numbers.Integral):
        return str(int(val))
    if isinstance(val, numbers.Rational):
        p, q = int(val.numerator), int(val.denominator)
        if q == 1:
            return str(p)
        if p < 0:
            return r"- \frac{%d}{%d}" % (-p, q)
        return r"\frac{%d}{%d}" % (p, q)
    if isinstance(val, float):
        return _latex_float(val)
    return str(val)


def _latex_radical_term(q: Fraction, d: int) -> str:
    """``sympy.latex`` of the product ``q·√|d|`` (times ``i`` where d < 0),
    q ≠ 0: the integer factors, then ``\\sqrt{|d|}``, then ``i``, over q's
    denominator as one ``\\frac``; a negative q gives a ``- `` prefix."""
    sign = "- " if q < 0 else ""
    num, den = abs(q.numerator), q.denominator
    parts = [str(num)] if num != 1 else []
    if abs(d) != 1:
        parts.append(r"\sqrt{%d}" % abs(d))
    if d < 0:
        parts.append("i")
    top = " ".join(parts)
    if den == 1:
        return sign + top
    return sign + r"\frac{%s}{%d}" % (top, den)


def latex_surd(p: Fraction, q: Fraction, d: int) -> str:
    """``sympy.latex`` of ``p + q·√d`` (q ≠ 0, d squarefree, d ≠ 0, 1; d < 0
    is ``i·√|d|``), the number as sympy's ``roots`` builds it.

    sympy orders an ``Add``'s terms by ``Expr.as_ordered_terms``: a
    positive rational and a negative radical keep that order; otherwise a
    real pair runs by value, ascending, and a complex pair puts the real
    part first.  Each term after the first is written ``- t`` or ``+ t``."""
    p, q = Fraction(p), Fraction(q)
    term = _latex_radical_term(q, d)
    if p == 0:
        return term
    radical_first = d > 0 and (
        (p < 0 and q < 0 and q * q * d > p * p)
        or (p > 0 and q > 0 and q * q * d < p * p))
    if radical_first:
        return term + (" - " if p < 0 else " + ") + latex_scalar(abs(p))
    return (latex_scalar(p) + (" - " if q < 0 else " + ")
            + _latex_radical_term(abs(q), d))


def cformat(val: Any, arg_of: Optional[str] = None) -> str:
    """Render ``val`` to LaTeX in operator context ``arg_of``."""
    custom = getattr(val, "cformat", None)
    if callable(custom):
        return custom(arg_of)
    if isinstance(val, str):
        return val
    as_latex = getattr(val, "as_latex", None)
    if callable(as_latex):
        return as_latex()
    return latex_scalar(val)


def pcformat(fstr: str, *vals) -> str:
    """Substitute ``%s`` placeholders in ``fstr`` with cformat-ted values.

    >>> pcformat(r"%s + %s = %s", 1, 2, 3)
    '1 + 2 = 3'
    """
    return fstr % tuple(cformat(v) for v in vals)


#: infix glyph per supported operator
_ARITH_GLYPH = {"+": "+", "-": "-", "*": r" \cdot "}


def pretty_print_arithmetic(a: Any, op: str, b: Any) -> str:
    """Render a binary arithmetic expression with sign-aware simplification:
    identity/annihilator absorption (``x±0``, ``0+x``, ``1·x``, ``0·x``),
    then a negative right operand is replaced by its magnitude — for
    ``*`` the sign migrates onto the left factor, for ``+``/``-`` it is
    simply dropped (callers feed magnitudes with a separately chosen
    operator), then ``cformat(a) ⟨glyph⟩ cformat(b)``."""
    glyph = _ARITH_GLYPH.get(op)
    if glyph is None:
        raise ValueError(f"Unsupported operator: {op!r}")

    if op == "*":
        # annihilator, then unit factors (left before right).
        if a == 0 or b == 0:
            return cformat(0)
        for unit, other in ((a, b), (b, a)):
            if unit == 1:
                return cformat(other)
    else:
        # additive absorption; "0 - b" folds the operator into b.
        if b == 0:
            return cformat(a)
        if a == 0:
            return cformat(b if op == "+" else -b)

    if b < 0:
        b = -b
        if op == "*":
            a = -a
    return cformat(a) + glyph + cformat(b)


# ---------------------------------------------------------------------------
# Matrix / vector builders
# ---------------------------------------------------------------------------

_ROW_SEP = "\\\\[0.1em]\n"


def make_latex_matrix(items: Sequence[Sequence[Any]]) -> str:
    body = _ROW_SEP.join(
        r" & ".join(cformat(item) for item in row) for row in items
    )
    return r"\begin{pmatrix}" + body + r"\end{pmatrix}"


def make_latex_vector(items: Sequence[Any]) -> str:
    body = _ROW_SEP.join(cformat(item) for item in items)
    return r"\begin{pmatrix}" + body + r"\end{pmatrix}"


def make_latex_augmented_matrix(
    items: Sequence[Sequence[Any]], bar_col: Optional[int] = None
) -> str:
    """Matrix with a vertical bar drawn before column ``bar_col``."""
    n_cols = len(items[0])
    if n_cols <= 1:
        return make_latex_matrix(items)
    if bar_col is None:
        bar_col = n_cols - 1
    col_spec = "".join("|c" if j == bar_col else "c" for j in range(n_cols))
    body = (" \\\\[0.1em]\n").join(
        r" & ".join(cformat(item) for item in row) for row in items
    )
    return (
        r"\left(\begin{array}{" + col_spec + "}\n"
        + body
        + "\n" + r"\end{array}\right)"
    )


def make_latex_vertical_augmented_matrix(
    header_row_latex: str, matrix_items: Sequence[Sequence[Any]], num_cols: int
) -> str:
    """Array with a header row (e.g. free-variable names) above an hline."""
    if num_cols <= 0:
        raise ValueError("num_cols must be positive")
    content_rows = [
        " & ".join(cformat(item) for item in row) for row in matrix_items
    ]
    if not content_rows:
        body = header_row_latex
    else:
        body = header_row_latex + r" \\ \hline " + r" \\ ".join(content_rows)
    return r"\left( \begin{array}{%s} %s \end{array} \right)" % (
        "c" * num_cols, body
    )


# ---------------------------------------------------------------------------
# Generic n-ary arithmetic (element-type aware)
# ---------------------------------------------------------------------------

def multi_add(items: List[Any]) -> Any:
    """Sum ``items``, delegating to the first item's ``multi_add`` if defined."""
    if not items:
        raise ValueError("At least one item is required")
    if len(items) == 1:
        return items[0]
    custom = getattr(items[0], "multi_add", None)
    if callable(custom):
        return custom(*items[1:])
    return sum(items)


def multi_add_vargs(*items) -> Any:
    return multi_add(list(items))


def prod(items: Sequence[Any]) -> Any:
    acc = 1
    for item in items:
        acc = acc * item
    return acc


def multi_mul(items: List[Any]) -> Any:
    """Multiply ``items``, delegating to ``multi_mul`` on the first if defined."""
    if not items:
        raise ValueError("At least one item is required")
    if len(items) == 1:
        return items[0]
    custom = getattr(items[0], "multi_mul", None)
    if callable(custom):
        return custom(*items[1:])
    return prod(items)


def scalar_mul(item: Any, scalar: Any) -> Any:
    custom = getattr(item, "scalar_mul", None)
    if callable(custom):
        return custom(scalar)
    return item * scalar


def linear_comb(scalars: Sequence[Any], items: Sequence[Any]) -> Any:
    if len(scalars) != len(items):
        raise ValueError("Scalars and items must have the same length")
    return multi_add([scalar_mul(it, s) for s, it in zip(scalars, items)])
