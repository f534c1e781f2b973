"""Sparse univariate polynomials over an arbitrary coefficient ring
(counterpart of ``linalg_solver_tpu.exact.polynomial``).

Used as the scalar domain for characteristic polynomials: the matrix
``A - lambda*I`` has ``Polynomial`` entries and runs through the full
determinant machinery (including the planner's fraction-free AddRow path,
whose final division is ``div_rem``'s exact long division).

Coefficients are ints, ``Fraction`` or anything with ring arithmetic; a
quotient of two ints is taken as a ``Fraction``, so division stays exact
where the JAX package divides ``sympy.Rational``; a float coefficient
divides as the JAX package's ``sympy`` RR and CC domains do (``nroots``).
The roots (``radical_roots``) are those of ``radicals``: rationals,
``p + q·√d``, the radicals of ``radexpr`` and float roots.
"""

from __future__ import annotations

import numbers
from decimal import Decimal, localcontext
from fractions import Fraction
from typing import Any, Dict, List, Tuple

from ..utils.fmt import cformat
from . import nroots, radexpr, radicals


def _exact_div(a: Any, b: Any) -> Any:
    """``a / b``, as a ``Fraction`` where both are integers."""
    if isinstance(a, numbers.Integral) and isinstance(b, numbers.Integral):
        return Fraction(int(a), int(b))
    return a / b


class LoneRootQuotient(NotImplementedError):
    """``factor_roots`` given one root of an irreducible factor but not
    the others (a cubic-formula root alone, as ``real_only`` keeps it):
    the quotient is sympy's EX-domain form, which is not ported
    (ROADMAP.md queue 1 item 7)."""


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
        ``{linear_factor: multiplicity}`` plus any nontrivial residual.

        Rationals and ``p + q·√d`` divide exactly, one root at a time.  The
        roots of an irreducible factor f of degree ≥ 3 (``radexpr.Radical``,
        ``minpoly`` f) divide together, by f/lc(f) over ℚ, once
        ∏(x − rᵢ) = f/lc(f) is checked at 40 digits.  Where only some of
        f's roots are given (``real_only``), single-term roots (binomial
        roots such as ∛2) divide one at a time in expanded arithmetic; a
        longer radical raises ``LoneRootQuotient``.  A radical root that
        fails the check or leaves a remainder raises ``ArithmeticError``.
        A polynomial with a float coefficient divides by each root as the
        JAX package's ``sympy.div`` over RR / CC does
        (``nroots.remove_float_root``: ``ValueError`` on a remainder)."""
        residual = self
        groups: Dict[Tuple[int, ...], List[Tuple[Any, int]]] = {}
        if not all(isinstance(c, numbers.Rational)
                   for c in self.powers.values()):
            powers = self.powers
            for root, mult in roots:
                for _ in range(mult):
                    powers = nroots.remove_float_root(powers, root)
            residual, exact = Polynomial(powers, self.var), []
        else:
            exact = roots
        for root, mult in exact:
            if isinstance(root, radexpr.Radical):
                groups.setdefault(root.minpoly, []).append((root, mult))
                continue
            for _ in range(mult):
                residual = residual.remove_root(root)
        for f, members in groups.items():
            mults = {m for _, m in members}
            if f is not None and len(members) == len(f) - 1 \
                    and len(mults) == 1:
                residual = residual._divide_by_factor(
                    f, [r for r, _ in members], mults.pop())
                continue
            for root, mult in members:
                if len(root.terms) != 1:
                    raise LoneRootQuotient(
                        f"{root} is one of several roots of an irreducible "
                        f"factor; the quotient by it alone is written in "
                        f"sympy's EX-domain forms, which are not ported "
                        f"(ROADMAP.md queue 1 item 7)")
                for _ in range(mult):
                    residual = residual._remove_radical_root(root)
        factors = {
            Polynomial({0: -root, 1: 1}, self.var): mult for root, mult in roots
        }
        if len(residual.powers) == 1 and residual.powers.get(0, 1) == 1:
            return factors
        return {residual: 1} | factors

    def _divide_by_factor(self, f: Tuple[int, ...], members: List[Any],
                          mult: int) -> "Polynomial":
        """Divide by (f/lc f)^mult, where ``members`` are all of f's roots:
        ∏(x − rᵢ) is checked against f/lc(f) at 40 digits first."""
        monic = [Fraction(x, f[0]) for x in f]
        with localcontext() as ctx:
            ctx.prec = 50
            prod = [(Decimal(1), Decimal(0))]
            for r in members:
                re_, im_ = r.value(50)
                nxt = prod + [(Decimal(0), Decimal(0))]
                for i, (a, b) in enumerate(prod):
                    nxt[i + 1] = (nxt[i + 1][0] - (a * re_ - b * im_),
                                  nxt[i + 1][1] - (a * im_ + b * re_))
                prod = nxt
            scale = max(abs(Decimal(x.numerator) / x.denominator)
                        for x in monic)
            for (a, b), want in zip(prod, monic):
                w = Decimal(want.numerator) / want.denominator
                if abs(a - w) + abs(b) > Decimal(10) ** -40 * (1 + scale):
                    raise ArithmeticError(
                        f"the radical roots do not multiply to the factor "
                        f"{list(f)}")
        deg = len(f) - 1
        divisor = Polynomial({deg - i: c for i, c in enumerate(monic)},
                             self.var)
        out = self
        for _ in range(mult):
            out, rem = out.div_rem(divisor)
            if rem.powers:
                raise ArithmeticError(
                    f"the factor {list(f)} does not divide the polynomial")
        return out

    def _remove_radical_root(self, root: Any) -> "Polynomial":
        """Synthetic division by ``(x - root)`` with every product expanded,
        as the JAX package's EX domain leaves a single-term radical's
        quotient; raises where the remainder is not zero."""
        deg = self.degree()
        quot: Dict[int, Any] = {}
        carry: Any = 0
        for e in range(deg, -1, -1):
            carry = radexpr.expand(radexpr.add(
                self.powers.get(e, 0), radexpr.expand_mul(root, carry)))
            if e:
                quot[e - 1] = carry
        if carry != 0:
            raise ArithmeticError(
                f"{root} is not a root of the polynomial, division resulted "
                f"in remainder {carry}")
        return Polynomial(quot, self.var)

    def radical_roots(self) -> Dict[Any, int]:
        """The roots, exactly, as the JAX package's ``sympy.roots`` gives
        them: {root: multiplicity} in sympy's order, each root a rational,
        a ``radicals.Surd`` ``p + q·√d``, a ``radexpr.Radical`` (cubic,
        quartic, binomial, cyclotomic and nested radicals) or, for a float
        coefficient, an ``nroots.Float`` / ``nroots.Complex``.  Where sympy
        has no formula for a factor the set is partial or empty, as there;
        the forms sympy writes that are not ported (roots written with
        atan) raise ``NotImplementedError``."""
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
