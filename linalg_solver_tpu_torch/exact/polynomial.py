"""Sparse univariate polynomials over an arbitrary coefficient ring
(counterpart of ``linalg_solver_tpu.exact.polynomial``).

Used as the scalar domain for characteristic polynomials: the matrix
``A - lambda*I`` has ``Polynomial`` entries and runs through the full
determinant machinery (including the planner's fraction-free AddRow path,
whose final division is ``div_rem``'s exact long division).

Coefficients are ints, ``Fraction`` or anything with ring arithmetic; a
quotient of two ints is taken as a ``Fraction``, so division stays exact
where the JAX package divides ``sympy.Rational``.  The roots in radicals
(``radical_roots``) are those of ``radicals``: rationals and ``p + q·√d``.
"""

from __future__ import annotations

import numbers
from fractions import Fraction
from typing import Any, Dict, List, Tuple

from ..utils.fmt import cformat
from . import radicals


def _exact_div(a: Any, b: Any) -> Any:
    """``a / b``, as a ``Fraction`` where both are integers."""
    if isinstance(a, numbers.Integral) and isinstance(b, numbers.Integral):
        return Fraction(int(a), int(b))
    return a / b


class Polynomial:
    """``{exponent: coefficient}`` plus a display variable name."""

    __slots__ = ("powers", "var")

    def __init__(self, powers: Dict[int, Any], var: str = "x"):
        self.powers = {e: c for e, c in powers.items() if c != 0}
        self.var = var

    # -- equality / hashing ----------------------------------------------
    def __eq__(self, other: Any) -> bool:
        if isinstance(other, (int, float)) and other == 0:
            return not self.powers
        if isinstance(other, Polynomial):
            return self.var == other.var and self.powers == other.powers
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.var, tuple(sorted(self.powers.items()))))

    # -- ring arithmetic --------------------------------------------------
    def multi_add(self, *others: Any) -> "Polynomial":
        acc = dict(self.powers)
        for other in others:
            if not isinstance(other, Polynomial):
                other = Polynomial({0: other})
            elif other.var != self.var:
                raise TypeError(
                    f"Cannot add Polynomials with different variables: "
                    f"'{self.var}' and '{other.var}'"
                )
            for exp, coef in other.powers.items():
                acc[exp] = acc.get(exp, 0) + coef
        return Polynomial(acc, self.var)

    def __add__(self, other: Any) -> "Polynomial":
        return self.multi_add(other)

    __radd__ = __add__

    def __neg__(self) -> "Polynomial":
        return Polynomial({e: -c for e, c in self.powers.items()}, self.var)

    def __sub__(self, other: Any) -> "Polynomial":
        return self + (-other)

    def __rsub__(self, other: Any) -> "Polynomial":
        return (-self) + other

    def __mul__(self, other: Any) -> "Polynomial":
        if not isinstance(other, Polynomial):
            return Polynomial(
                {e: c * other for e, c in self.powers.items()}, self.var
            )
        if other.var != self.var:
            raise TypeError(
                f"Cannot multiply Polynomials with different variables: "
                f"'{self.var}' and '{other.var}'"
            )
        acc: Dict[int, Any] = {}
        for e1, c1 in self.powers.items():
            for e2, c2 in other.powers.items():
                acc[e1 + e2] = acc.get(e1 + e2, 0) + c1 * c2
        return Polynomial(acc, self.var)

    __rmul__ = __mul__

    # -- degree / evaluation ---------------------------------------------
    def degree(self) -> int:
        return max(self.powers.keys(), default=0)

    def __call__(self, x: Any) -> Any:
        acc = 0
        for e, c in self.powers.items():
            acc = acc + c * x**e
        return acc

    # -- exact division -----------------------------------------------------
    def div_rem(self, divisor: Any) -> Tuple["Polynomial", "Polynomial"]:
        """Long division: ``(q, r)`` with ``self = q·divisor + r`` and
        ``deg r < deg divisor`` (``r`` zero for a constant divisor)."""
        if not isinstance(divisor, Polynomial):
            divisor = Polynomial({0: divisor}, self.var)
        elif divisor.var != self.var:
            raise TypeError(
                f"Cannot divide Polynomials with different variables: "
                f"'{self.var}' and '{divisor.var}'"
            )
        if not divisor.powers:
            raise ZeroDivisionError("division by the zero polynomial")
        d_deg = divisor.degree()
        lead = divisor.powers[d_deg]
        rem = dict(self.powers)
        quot: Dict[int, Any] = {}
        while rem and max(rem) >= d_deg:
            top = max(rem)
            c = _exact_div(rem[top], lead)
            quot[top - d_deg] = c
            for e, dc in divisor.powers.items():
                k = e + top - d_deg
                rem[k] = rem.get(k, 0) - c * dc
            del rem[top]    # cancelled exactly (a float would leave a trace)
            rem = {e: v for e, v in rem.items() if v != 0}
        return Polynomial(quot, self.var), Polynomial(rem, self.var)

    # -- root manipulation ------------------------------------------------
    def remove_root(self, root: Any) -> "Polynomial":
        """Exact division by ``(x - root)``; raises if the remainder is
        nonzero."""
        if not self.powers:
            return Polynomial({}, self.var)
        quotient, remainder = self.div_rem(Polynomial({0: -root, 1: 1}, self.var))
        if remainder.powers:
            raise ValueError(
                f"{root} is not a root of the polynomial, division resulted "
                f"in remainder {remainder}"
            )
        return quotient

    def factor_roots(
        self, roots: List[Tuple[Any, int]]
    ) -> Dict["Polynomial", int]:
        """Factor out ``(x - r)^mult`` for each known root, returning
        ``{linear_factor: multiplicity}`` plus any nontrivial residual."""
        residual = self
        for root, mult in roots:
            for _ in range(mult):
                residual = residual.remove_root(root)
        factors = {
            Polynomial({0: -root, 1: 1}, self.var): mult for root, mult in roots
        }
        if len(residual.powers) == 1 and residual.powers.get(0, 1) == 1:
            return factors
        return {residual: 1} | factors

    def radical_roots(self) -> Dict[Any, int]:
        """All roots, exactly, as the JAX package's ``sympy.roots`` gives
        them: {root: multiplicity} in sympy's order, each root a rational
        or a ``radicals.Surd`` ``p + q·√d``.  A factor of degree ≥ 3 that
        is irreducible over ℚ raises ``NotImplementedError``."""
        return radicals.radical_roots(self.powers)

    # -- rendering --------------------------------------------------------
    def cformat(self, arg_of: str = None) -> str:
        parts = ""
        for exp, coef in sorted(self.powers.items(), key=lambda kv: -kv[0]):
            if coef == 0:
                continue
            if cformat(coef).startswith("-"):
                parts += "-"
                coef = -coef
            elif parts:
                parts += "+"
            coef_str = "" if (coef == 1 and exp != 0) else cformat(coef)
            if exp == 0:
                parts += coef_str
            else:
                pow_str = "" if exp == 1 else r"^{%s}" % exp
                parts += r"%s{%s}%s" % (coef_str, self.var, pow_str)
        if not parts:
            parts = "0"
        if arg_of is None or arg_of == "+":
            return parts
        # A monomial needs no parentheses unless it is negated under "*".
        if len(self.powers) <= 1 and not (parts.startswith("-") and arg_of == "*"):
            return parts
        return "(%s)" % parts

    def __repr__(self) -> str:
        return f"Polynomial({self.powers!r}, var={self.var!r})"

    def __str__(self) -> str:
        return self.cformat()
