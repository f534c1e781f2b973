"""The port's roots of cyclotomic polynomials and binomials of every degree
against the JAX package's ``Polynomial.radical_roots`` (sympy's
``roots_cyclotomic`` and ``roots_binomial``), with no sympy in the port:

- ``cos(r·π)`` and ``sin(r·π)`` for every r = p/q, q ≤ 30, |p| ≤ 2q, as
  sympy evaluates them: radicals (Chebyshev, half angles, its product
  table) or the unevaluated ``\\cos{\\left(\\frac{2 \\pi}{9} \\right)}``;
- Φₙ for n ≤ 30: exp(2πik/n) in sympy's order of k, and through
  ``_try_decompose`` where Φₙ is Φₘ(x^(n/m)) (Φ₉ = x⁶ + x³ + 1 gives
  ``\\cos{\\left(\\frac{2 \\pi}{9} \\right)} - i \\sin{…}``); Φ₂₀, Φ₂₅, Φ₂₇
  and Φ₂₈, whose roots sympy writes with ``atan``, raise
  ``NotImplementedError`` citing ROADMAP.md queue 1 item 7;
- a·xⁿ − b for n = 5 … 12 (x⁵ + 2 and x⁷ − 3 among them);

each the same dict order, ``sympy.latex`` of every root and its negation,
``is_real`` and the value within 1e-25 relative of sympy's ``N(·, 40)``.
"""

from decimal import Decimal
from fractions import Fraction

import pytest
import sympy

from linalg_solver_tpu.exact.polynomial import Polynomial as JPoly
from linalg_solver_tpu_torch.exact import radexpr, radicals
from linalg_solver_tpu_torch.utils import fmt as tfmt

X = sympy.symbols("x")
ATAN = (20, 25, 27, 28)


def _check(coeffs):
    deg = len(coeffs) - 1
    powers = {deg - i: c for i, c in enumerate(coeffs) if c}
    port = radicals.radical_roots(dict(powers))
    want = JPoly(dict(powers)).radical_roots()
    assert len(port) == len(want)
    for (rp, mp), (rs, ms) in zip(port.items(), want.items()):
        assert mp == ms
        assert tfmt.cformat(rp) == sympy.latex(rs)
        assert tfmt.cformat(-rp) == sympy.latex(-rs)
        assert (getattr(rp, "is_real", True) is True) == (rs.is_real is True)
        w = sympy.N(rs, 40)
        w_re, w_im = Decimal(str(sympy.re(w))), Decimal(str(sympy.im(w)))
        if isinstance(rp, (int, Fraction)):
            re_, im_ = Decimal(Fraction(rp).numerator) / \
                Fraction(rp).denominator, Decimal(0)
        else:
            re_, im_ = rp.value(45)
        assert abs(re_ - w_re) + abs(im_ - w_im) <= Decimal("1e-25") * (
            1 + abs(w_re) + abs(w_im))
    return port


def test_cos_and_sin_of_rational_multiples_of_pi():
    for q in range(2, 31):
        for p in range(-2 * q, 2 * q + 1):
            arg = sympy.Rational(p, q) * sympy.pi
            for ours, theirs in ((radexpr.cos_pi, sympy.cos),
                                 (radexpr.sin_pi, sympy.sin)):
                assert tfmt.cformat(ours(Fraction(p, q))) == \
                    sympy.latex(theirs(arg)), (ours.__name__, p, q)


def _phi(n):
    return [int(c) for c in
            sympy.Poly(sympy.cyclotomic_poly(n, X), X).all_coeffs()]


@pytest.mark.parametrize("group", [range(1, 9), range(9, 17), range(17, 24),
                                   range(24, 31)])
def test_cyclotomic_roots_match_jax(group):
    for n in group:
        if n in ATAN:
            with pytest.raises(NotImplementedError, match="queue 1 item 7"):
                _check(_phi(n))
            continue
        got = _check(_phi(n))
        if n == 9:
            assert tfmt.cformat(next(iter(got))) == (
                r"\cos{\left(\frac{2 \pi}{9} \right)} - i \sin{\left("
                r"\frac{2 \pi}{9} \right)}")


@pytest.mark.parametrize("degrees", [(5, 6), (7, 8), (9, 10), (11, 12)])
def test_binomials_of_every_degree_match_jax(degrees):
    for degree in degrees:
        for b in (2, -2, 3, -3, 8, -16, 81):
            for lead in (1, 2):
                _check([lead] + [0] * (degree - 1) + [-b])
