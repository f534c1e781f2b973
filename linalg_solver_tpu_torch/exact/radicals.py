"""Exact roots of rational polynomials in ``ℚ(√d)``: the port's
counterpart of the JAX package's ``sympy.roots(poly, multiple=False)``
(``linalg_solver_tpu.exact.polynomial.Polynomial.radical_roots``).

A root is a rational (``int`` or ``Fraction``) or a ``Surd`` ``p + q·√d``
(d a squarefree integer, d < 0 for ``i·√|d|``), which prints as
``sympy.latex`` prints the same number (``utils.fmt.latex_surd``).  So the
roots of every factor of degree ≤ 2 over ℚ are found; a factor of degree
≥ 3 that is irreducible over ℚ raises ``NotImplementedError`` (sympy
would write cube or quartic radicals; ROADMAP.md queue 1 item 7).

The order of the returned dict is sympy's, which the LaTeX text shows:
``roots`` strips the zero roots (added back last), makes the polynomial a
primitive integer one, rescales x by ``_integer_basis``, then takes a
linear polynomial's root, a binomial's roots (``roots_quadratic`` at
degree 2, else ``roots_binomial``'s order of the n-th roots), a lone
quadratic's two roots, or each factor's roots in the order of
``factor_list`` (``_sort_factors``: by length, multiplicity, then the
coefficient list).  A quadratic's roots come as ``B - |D|``, ``B + |D|``.
"""

from __future__ import annotations

import cmath
import math
import numbers
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.fmt import latex_surd

_QUEUE = "ROADMAP.md queue 1 item 7"


# ---------------------------------------------------------------------------
# p + q·√d
# ---------------------------------------------------------------------------

def _squarefree(n: int) -> Tuple[int, int]:
    """``(s, d)`` with ``n = s²·d``, d squarefree (carrying n's sign)."""
    sign, n = (-1 if n < 0 else 1), abs(n)
    s, d, f = 1, 1, 2
    while f * f <= n:
        while n % (f * f) == 0:
            n //= f * f
            s *= f
        if n % f == 0:
            n //= f
            d *= f
        f += 1
    return s, sign * d * n


def _rational(x: Fraction):
    """An integral Fraction as an int, as sympy makes an Integer."""
    return int(x) if x.denominator == 1 else x


def surd(p, q, d: int):
    """``p + q·√d`` as a ``Surd``, or as a rational where q·√d is."""
    p, q = Fraction(p), Fraction(q)
    if q == 0 or d == 0:
        return _rational(p)
    s, d = _squarefree(d)
    if d == 1:
        return _rational(p + q * s)
    return Surd(p, q * s, d)


class Surd:
    """The exact number ``p + q·√d`` (q ≠ 0, d squarefree, d ∉ {0, 1})."""

    __slots__ = ("p", "q", "d")

    def __init__(self, p: Fraction, q: Fraction, d: int):
        self.p, self.q, self.d = p, q, d

    # -- arithmetic within ℚ(√d) -------------------------------------------
    def _parts(self, other) -> Optional[Tuple[Fraction, Fraction]]:
        if isinstance(other, Surd):
            if other.d != self.d:
                raise TypeError(
                    f"Surd arithmetic across two fields (√{self.d}, "
                    f"√{other.d}) is not supported")
            return other.p, other.q
        if isinstance(other, numbers.Rational):
            return Fraction(other), Fraction(0)
        return None

    def __add__(self, other):
        o = self._parts(other)
        if o is None:
            return NotImplemented
        return surd(self.p + o[0], self.q + o[1], self.d)

    __radd__ = __add__

    def __neg__(self):
        return Surd(-self.p, -self.q, self.d)

    def __sub__(self, other):
        o = self._parts(other)
        if o is None:
            return NotImplemented
        return surd(self.p - o[0], self.q - o[1], self.d)

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        o = self._parts(other)
        if o is None:
            return NotImplemented
        p, q = o
        return surd(self.p * p + self.q * q * self.d,
                    self.p * q + self.q * p, self.d)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._parts(other)
        if o is None:
            return NotImplemented
        p, q = o
        if q == 0:
            return surd(self.p / p, self.q / p, self.d)
        den = p * p - q * q * self.d
        return self * surd(p / den, -q / den, self.d)

    # -- comparison --------------------------------------------------------
    def __eq__(self, other) -> bool:
        if isinstance(other, Surd):
            return (self.p, self.q, self.d) == (other.p, other.q, other.d)
        if isinstance(other, numbers.Number):
            return False
        return NotImplemented

    def __hash__(self) -> int:
        return hash(("Surd", self.p, self.q, self.d))

    @property
    def is_real(self) -> bool:
        return self.d > 0

    def __complex__(self) -> complex:
        return complex(self.p) + complex(self.q) * cmath.sqrt(self.d)

    # -- rendering ---------------------------------------------------------
    def cformat(self, arg_of: Optional[str] = None) -> str:
        return latex_surd(self.p, self.q, self.d)

    def __repr__(self) -> str:
        return f"Surd({self.p}, {self.q}, {self.d})"


# ---------------------------------------------------------------------------
# Integer polynomials: lists of ints, highest degree first
# ---------------------------------------------------------------------------

def _trim(c: List) -> List:
    i = 0
    while i < len(c) - 1 and c[i] == 0:
        i += 1
    return c[i:]


def _primitive(c: List) -> List[int]:
    """Integer coefficients over the gcd, the leading sign kept (as
    ``clear_denoms`` and ``primitive`` leave it)."""
    den = 1
    for x in c:
        den = den * Fraction(x).denominator // math.gcd(
            den, Fraction(x).denominator)
    ints = [int(Fraction(x) * den) for x in c]
    g = 0
    for x in ints:
        g = math.gcd(g, x)
    return [x // g for x in ints]


def _positive(c: List[int]) -> List[int]:
    """The primitive polynomial with a positive leading coefficient (a
    factor as ``factor_list`` writes it)."""
    c = _primitive(c)
    return [-x for x in c] if c[0] < 0 else c


def _divmod(num: List, den: List) -> Tuple[List, List]:
    """Exact long division over ℚ."""
    num = [Fraction(x) for x in num]
    out = []
    while len(num) >= len(den):
        c = num[0] / den[0]
        out.append(c)
        for i, x in enumerate(den):
            num[i] -= c * x
        num.pop(0)
    return out or [Fraction(0)], _trim(num) if num else [Fraction(0)]


def _divides(num: List, den: List) -> Optional[List]:
    q, r = _divmod(num, den)
    return q if all(x == 0 for x in r) else None


def _gcd(a: List, b: List) -> List:
    a, b = [Fraction(x) for x in a], [Fraction(x) for x in b]
    while any(x != 0 for x in b):
        _, r = _divmod(a, b)
        a, b = b, r
    return [x / a[0] for x in a]


def _derivative(c: List) -> List:
    n = len(c) - 1
    return [x * (n - i) for i, x in enumerate(c[:-1])] or [0]


def _divisors(n: int) -> List[int]:
    n = abs(n)
    small = [k for k in range(1, math.isqrt(n) + 1) if n % k == 0]
    return sorted(set(small + [n // k for k in small]))


def _integer_basis(c: List[int]) -> Optional[int]:
    """sympy's ``polyroots._integer_basis``: the integer ``b`` with
    ``p(b·y) = m·q(y)`` on smaller coefficients, or None."""
    terms = [(len(c) - 1 - i, abs(x)) for i, x in enumerate(c) if x != 0]
    monoms = [m for m, _ in terms]
    coeffs = [x for _, x in terms]
    if not coeffs[0] < coeffs[-1]:
        return None
    coeffs = coeffs[::-1]
    n = monoms[0]
    monoms = [n - m for m in monoms[::-1]]
    monoms, coeffs = monoms[:-1], coeffs[:-1]
    if len(monoms) == 1:
        r = round(coeffs[0] ** (1.0 / monoms[0]))
        for cand in (r - 1, r, r + 1):
            if cand > 0 and cand ** monoms[0] == coeffs[0]:
                return cand
        return None
    g = 0
    for x in coeffs:
        g = math.gcd(g, x)
    for div in reversed(_divisors(g)[1:]):
        if all(x % div ** m == 0 for m, x in zip(monoms, coeffs)):
            return div
    return None


def _rational_roots(c: List[int]) -> Tuple[List[Tuple[Fraction, int]], List]:
    """Rational roots with multiplicities, and the rest of ``c``."""
    roots = []
    cands = [Fraction(s * p, q) for p in _divisors(c[-1])
             for q in _divisors(c[0]) for s in (1, -1)]
    for r in cands:
        if any(r == x for x, _ in roots):
            continue
        mult = 0
        while len(c) > 1:
            quot = _divides(c, [r.denominator, -r.numerator])
            if quot is None:
                break
            c, mult = quot, mult + 1
        if mult:
            roots.append((r, mult))
    return roots, c


def _squarefree_parts(c: List) -> List[Tuple[List, int]]:
    """Yun's squarefree decomposition: ``[(s_i, i)]`` with c = ∏ s_iⁱ."""
    out = []
    a = _gcd(c, _derivative(c))
    b = _divmod(c, a)[0]
    d = _sub(_divmod(_derivative(c), a)[0], _derivative(b))
    i = 1
    while len(b) > 1:
        a = _gcd(b, d)
        if len(a) > 1:
            out.append((a, i))
        b = _divmod(b, a)[0]
        d = _sub(_divmod(d, a)[0], _derivative(b))
        i += 1
    return out


def _sub(a: List, b: List) -> List:
    n = max(len(a), len(b))
    a = [0] * (n - len(a)) + list(a)
    b = [0] * (n - len(b)) + list(b)
    return _trim([Fraction(x) - Fraction(y) for x, y in zip(a, b)])


def _quadratic_factors(c: List[int]) -> List[List[int]]:
    """Split a squarefree integer polynomial without rational roots into
    quadratic factors over ℤ, or raise where an irreducible factor of
    degree ≥ 3 is left.  Candidates pair the float roots; each is
    checked by exact division."""
    found = []
    while len(c) > 3:
        roots = np.roots(np.array([float(x) for x in c]))
        lead = abs(c[0])
        quad = None
        for i in range(len(roots)):
            for j in range(i + 1, len(roots)):
                s, p = roots[i] + roots[j], roots[i] * roots[j]
                if abs(s.imag) > 1e-6 * (1 + abs(s)) or \
                        abs(p.imag) > 1e-6 * (1 + abs(p)):
                    continue
                for a in _divisors(lead):
                    cand = [a, -round(a * s.real), round(a * p.real)]
                    if cand[2] == 0:
                        continue
                    quot = _divides(c, cand)
                    if quot is not None:
                        quad = cand
                        break
                if quad:
                    break
            if quad:
                break
        if quad is None:
            raise NotImplementedError(
                f"Polynomial.radical_roots: an irreducible factor of degree "
                f"{len(c) - 1} over Q has roots outside Q(sqrt d), which are "
                f"not ported ({_QUEUE})")
        found.append(_positive(quad))
        c = _primitive(_divides(c, quad))
    if len(c) == 3:
        found.append(_positive(c))
    return found


def _factor_list(c: List[int]) -> List[Tuple[List[int], int]]:
    """Irreducible factors over ℤ (positive leading coefficients) with
    multiplicities, in ``_sort_factors`` order: length, multiplicity,
    coefficient list."""
    factors = []
    roots, rest = _rational_roots(c)
    for r, m in roots:
        factors.append(([r.denominator, -r.numerator], m))
    if len(rest) > 1:
        for part, m in _squarefree_parts(_primitive(rest)):
            for f in _quadratic_factors(_primitive(part)):
                factors.append((f, m))
    return sorted(factors, key=lambda fm: (len(fm[0]), fm[1], fm[0]))


# ---------------------------------------------------------------------------
# sympy's root formulas
# ---------------------------------------------------------------------------

def _sqrt(r: Fraction):
    """``sqrt(r)`` as sympy simplifies it: a rational, or ``q·√d``."""
    s, d = _squarefree(r.numerator * r.denominator)
    return surd(0, Fraction(s, r.denominator), d)


def _quadratic(a: int, b: int, c: int) -> List:
    """``roots_quadratic`` (and ``roots_binomial`` at degree 2): the root
    with the radical subtracted first."""
    a, b, c = Fraction(a), Fraction(b), Fraction(c)
    if b == 0:
        big = _sqrt(-c / a)
        return [-big, big]
    s, d = _squarefree(int(b * b - 4 * a * c))
    B = -b / (2 * a)
    big = surd(0, Fraction(s) / (2 * abs(a)), d)
    return [B - big, B + big]


def _binomial(c: List[int]) -> List:
    """``roots_binomial`` of ``a·xⁿ + b``: every n-th root of ``-b/a``, in
    sympy's order of k (the root ``alpha·exp(2πik/n)``, alpha the
    principal root)."""
    n = len(c) - 1
    base = Fraction(-c[-1], c[0])
    exact = []
    for f, m in _factor_list(c):
        exact += _factor_roots(f) * m
    if len(exact) != n:
        raise NotImplementedError(
            f"Polynomial.radical_roots: the {n}-th roots of {base} are not "
            f"all in Q(sqrt d) ({_QUEUE})")
    neg = base < 0
    even = n % 2 == 0
    ks, imax = [], n // 2
    if even:
        ks.append(imax)
        imax -= 1
    if not neg:
        ks.append(0)
    for i in range(imax, 0, -1):
        ks.extend([i, -i] if neg else [-i, i])
    if neg:
        ks.append(0)
    rho = abs(float(base)) ** (1.0 / n)
    out = []
    for k in ks:
        want = rho * cmath.exp(1j * math.pi * ((1 if neg else 0) + 2 * k) / n)
        out.append(min(exact, key=lambda r: abs(complex(r) - want)))
    return out


def _factor_roots(f: List[int]) -> List:
    """``_try_heuristics`` on one irreducible factor of ``factor_list``."""
    if len(f) == 2:
        return [_rational(Fraction(-f[1], f[0]))]
    if len(f) == 3:
        return _quadratic(*f)
    raise NotImplementedError(
        f"Polynomial.radical_roots: an irreducible factor of degree "
        f"{len(f) - 1} over Q is not ported ({_QUEUE})")


def radical_roots(powers: Dict[int, Any]) -> Dict[Any, int]:
    """``{root: multiplicity}`` of ``Σ c_e·x^e`` in sympy's order, the
    coefficients rational."""
    if not powers:
        return {}
    for c in powers.values():
        if not isinstance(c, numbers.Rational):
            raise NotImplementedError(
                f"Polynomial.radical_roots: coefficient {c!r} is not "
                f"rational; only rational polynomials are ported ({_QUEUE})")
    low = min(powers)
    zeros = {0: low} if low else {}
    deg = max(powers) - low
    coeffs = _primitive([powers.get(e, 0) for e in range(max(powers),
                                                         low - 1, -1)])
    basis = _integer_basis(coeffs) if deg > 0 else None
    if basis:
        coeffs = [x // basis ** i for i, x in enumerate(coeffs)]
    result: Dict[Any, int] = {}

    def add(root, mult=1):
        result[root] = result.get(root, 0) + mult

    nonzero = sum(1 for x in coeffs if x != 0)
    if deg == 1:
        add(_rational(Fraction(-coeffs[1], coeffs[0])))
    elif deg >= 2 and nonzero == 2:
        for r in (_quadratic(coeffs[0], 0, coeffs[2]) if deg == 2
                  else _binomial(coeffs)):
            add(r)
    elif deg >= 2:
        factors = _factor_list(coeffs)
        if len(factors) == 1 and deg == 2:
            for r in _quadratic(*coeffs):
                add(r)
        elif len(factors) == 1 and factors[0][1] == 1:
            raise NotImplementedError(
                f"Polynomial.radical_roots: the polynomial is irreducible of "
                f"degree {deg} over Q; its roots are not ported ({_QUEUE})")
        else:
            for f, m in factors:
                for r in _factor_roots(f):
                    add(r, m)
    if basis:
        result = {r * basis: m for r, m in result.items()}
    result.update(zeros)
    return result
