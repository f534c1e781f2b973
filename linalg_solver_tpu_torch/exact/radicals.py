"""Exact roots of polynomials: the port's counterpart of the JAX
package's ``sympy.roots(poly, multiple=False)``
(``linalg_solver_tpu.exact.polynomial.Polynomial.radical_roots``).

A root of a rational polynomial is a rational (``int`` or ``Fraction``), a
``Surd`` ``p + q·√d`` (d a squarefree integer, d < 0 for ``i·√|d|``),
which prints as ``sympy.latex`` prints the same number
(``utils.fmt.latex_surd``), or a ``radexpr.Radical`` built step by step as
sympy builds it: ``roots_cubic`` (``trig=False``), ``roots_quartic``
(every branch rational coefficients reach), ``roots_binomial`` and
``roots_cyclotomic`` at every degree (cosines of π/n in radicals where
sympy evaluates them, else ``radexpr.Trig``), and ``_try_decompose``'s
roots of g(h(x)) (binomials and quadratics over EX).  A polynomial with a
float coefficient takes ``nroots``, as sympy's RR domain does.

The order of the returned dict is sympy's, which the LaTeX text shows:
``roots`` strips the zero roots (added back last), makes the polynomial a
primitive integer one, rescales x by ``_integer_basis``, then takes a
linear polynomial's root, a binomial's roots (``roots_quadratic`` at
degree 2, else ``roots_binomial``'s order of the n-th roots), a lone
quadratic's two roots, an irreducible polynomial's roots through
``_try_decompose``, or each factor's roots in the order of ``factor_list``
(``_sort_factors``: by length, multiplicity, then the coefficient list).
The factors are exact (``zfactor``: Zassenhaus over ℤ).  As in sympy
(``quintics=False``), a factor of degree ≥ 5 that is neither a binomial
nor cyclotomic nor decomposable has no roots: the dict is then partial,
or empty.  What sympy writes in forms not ported raises
``NotImplementedError`` citing ROADMAP.md queue 1 item 7: a root written
with ``atan`` (the principal root of a complex number at an angle atan
does not evaluate), ``roots_quadratic`` over EX with a Gaussian
coefficient, cubic or quartic inner components of a decomposition, and
a coefficient neither rational nor float (sympy's EX).  Where Ferrari's
formula takes the cube root of a complex or negative number
(``quartic_branch``), sympy orders and branches the terms by the rounding
noise of its ``evalf``: the port writes the same roots, exactly, in terms
that can be ordered or branched otherwise (item 7 too).
"""

from __future__ import annotations

import cmath
import functools
import math
import numbers
from decimal import Decimal, localcontext
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

from ..utils.fmt import cformat, latex_surd
from . import nroots, zfactor

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

    # -- arithmetic within ℚ(√d); across two fields in ``radexpr`` --------
    def _parts(self, other) -> Optional[Tuple[Fraction, Fraction]]:
        if isinstance(other, Surd):
            if other.d != self.d:
                return None
            return other.p, other.q
        if isinstance(other, numbers.Rational):
            return Fraction(other), Fraction(0)
        return None

    def _other_field(self, other) -> bool:
        return isinstance(other, Surd) and other.d != self.d

    def __add__(self, other):
        if self._other_field(other):
            return rx.add(self, other)
        o = self._parts(other)
        if o is None:
            return NotImplemented
        return surd(self.p + o[0], self.q + o[1], self.d)

    __radd__ = __add__

    def __neg__(self):
        return Surd(-self.p, -self.q, self.d)

    def __sub__(self, other):
        if self._other_field(other):
            return rx.add(self, -other)
        o = self._parts(other)
        if o is None:
            return NotImplemented
        return surd(self.p - o[0], self.q - o[1], self.d)

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        if self._other_field(other):
            return rx.expand_mul(self, other)
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

    def __rtruediv__(self, other):
        if isinstance(other, numbers.Rational):
            norm = self.p * self.p - self.q * self.q * self.d
            return Surd(self.p, -self.q, self.d) * (Fraction(other) / norm)
        return NotImplemented

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

    def value(self, digits: int = 60) -> Tuple[Decimal, Decimal]:
        """The value as (real, imaginary) Decimals to ``digits`` digits."""
        with localcontext() as ctx:
            ctx.prec = digits + 10
            p = Decimal(self.p.numerator) / self.p.denominator
            q = Decimal(self.q.numerator) / self.q.denominator
            r = q * Decimal(abs(self.d)).sqrt()
            ctx.prec = digits
            return (+(p + r), Decimal(0)) if self.d > 0 else (+p, +r)

    # -- rendering ---------------------------------------------------------
    def cformat(self, arg_of: Optional[str] = None) -> str:
        return latex_surd(self.p, self.q, self.d)

    def __repr__(self) -> str:
        return f"Surd({self.p}, {self.q}, {self.d})"


# ``radexpr`` builds on ``Surd``, so it is imported once ``Surd`` exists
from . import radexpr as rx  # noqa: E402


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


def _mul(a: List, b: List) -> List[Fraction]:
    out = [Fraction(0)] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] += x * y
    return out


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
            for f in zfactor.factor_squarefree(_positive(part)):
                factors.append((f, m))
    return sorted(factors, key=lambda fm: (len(fm[0]), fm[1], fm[0]))


def rank_over_field(items: List[List[Any]], minpoly) -> int:
    """rank(A − tI) over ℚ[t]/(f) for a rational A and an irreducible f
    (``minpoly``): Gaussian elimination on polynomials in t (highest
    degree first) reduced mod f, inverses by the extended Euclidean
    algorithm."""
    f = [Fraction(x) for x in minpoly]

    def red(a):
        return _divmod(a, f)[1]

    def inverse(a):
        r0, r1, s0, s1 = f, a, [Fraction(0)], [Fraction(1)]
        while len(r1) > 1:
            q, r = _divmod(r0, r1)
            r0, r1, s0, s1 = r1, r, s1, _sub(s0, _mul(q, s1))
        return red([x / r1[0] for x in s1])

    n = len(items)
    rows = [[red([Fraction(items[i][j])] if i != j
                 else [Fraction(-1), Fraction(items[i][j])])
             for j in range(n)] for i in range(n)]
    rank = 0
    for col in range(n):
        piv = next((r for r in range(rank, n) if rows[r][col] != [0]), None)
        if piv is None:
            continue
        rows[rank], rows[piv] = rows[piv], rows[rank]
        inv = inverse(rows[rank][col])
        rows[rank] = [red(_mul(x, inv)) for x in rows[rank]]
        for r in range(n):
            if r != rank and rows[r][col] != [0]:
                c = rows[r][col]
                rows[r] = [red(_sub(x, _mul(c, y)))
                           for x, y in zip(rows[r], rows[rank])]
        rank += 1
    return rank


# ---------------------------------------------------------------------------
# Cyclotomic and composed polynomials (what sympy's dispatch tests)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cyclotomic(m: int) -> Tuple[int, ...]:
    """Φ_m, highest degree first."""
    num = [1] + [0] * (m - 1) + [-1]
    for d in range(1, m):
        if m % d == 0:
            num = [int(x) for x in _divmod(num, list(_cyclotomic(d)))[0]]
    return tuple(num)


def _cyclotomic_index(f: List[int]) -> Optional[int]:
    """The m with Φ_m = f (``Poly.is_cyclotomic`` of an irreducible factor:
    monic with a ±1 constant term), or None."""
    if f[0] != 1 or f[-1] not in (1, -1):
        return None
    n = len(f) - 1
    for m in range(1, 4 * n * n + 3):
        if sum(1 for k in range(1, m + 1) if math.gcd(k, m) == 1) == n \
                and _cyclotomic(m) == tuple(f):
            return m
    return None


def _right_decompose(f: List[Fraction], s: int) -> List[Fraction]:
    """sympy's ``_dup_right_decompose``: the h of degree s (h(0) = 0) with
    f = g(h) if one exists."""
    n = len(f) - 1
    lc = f[0]
    fd = {n - i: x for i, x in enumerate(f) if x != 0}
    g = {s: Fraction(1)}
    r = n // s
    for i in range(1, s):
        coeff = Fraction(0)
        for j in range(0, i):
            if n + j - i not in fd or s - j not in g:
                continue
            coeff += (i - r * j) * fd[n + j - i] * g[s - j]
        g[s - i] = coeff / (i * r * lc)
    return [g.get(e, Fraction(0)) for e in range(s, -1, -1)]


def _left_decompose(f: List[Fraction], h: List[Fraction]) -> Optional[List[Fraction]]:
    """sympy's ``_dup_left_decompose``: g with f = g(h), or None."""
    g: Dict[int, Fraction] = {}
    i = 0
    while any(x != 0 for x in f):
        q, r = _divmod(f, h)
        if len(r) > 1:
            return None
        g[i] = r[0]
        f, i = q, i + 1
    return [g.get(e, Fraction(0)) for e in range(max(g), -1, -1)]


def _decompose(f: List[int]) -> List[List[Fraction]]:
    """``Poly.decompose`` over QQ: ``[g, h_k, …, h_1]`` with
    f = g(h_k(…h_1(x))), each hᵢ monic with no constant term; sympy peels
    the right factor of least degree until none is left."""
    g = [Fraction(x) for x in f]
    chain: List[List[Fraction]] = []
    while True:
        df = len(g) - 1
        for s in range(2, df):
            if df % s:
                continue
            h = _right_decompose(g, s)
            outer = _left_decompose(g, h)
            if outer is not None:
                g = outer
                chain.insert(0, h)
                break
        else:
            return [g] + chain


# ---------------------------------------------------------------------------
# sympy's root formulas
# ---------------------------------------------------------------------------

def _sqrt(r: Fraction):
    """``sqrt(r)`` as sympy simplifies it: a rational, or ``q·√d``."""
    s, d = _squarefree(r.numerator * r.denominator)
    return surd(0, Fraction(s, r.denominator), d)


def _quadratic(a, b, c) -> List:
    """``roots_quadratic`` of a·x² + b·x + c with rational coefficients
    (and ``roots_binomial`` at degree 2): 0 and −b/a in increasing order
    where c = 0, else the root with the radical subtracted first (the two
    swapped where a < 0)."""
    a, b, c = Fraction(a), Fraction(b), Fraction(c)
    if c == 0:
        r0, r1 = 0, _rational(-b / a)
        return [r1, r0] if r1 < 0 else [r0, r1]
    if b == 0:
        big = _sqrt(-c / a)
        return [-big, big]
    B = -b / (2 * a)
    D = _sqrt(b * b - 4 * a * c) / (2 * a)
    r0, r1 = B - D, B + D
    return [r1, r0] if a < 0 else [r0, r1]


def _multiple(coeffs: List) -> List:
    """``roots(coeffs, multiple=True)``: the roots in sympy's ``ordered``
    order (node count, then ``sort_key``), each as often as it is
    repeated."""
    deg = len(coeffs) - 1
    got = radical_roots({deg - i: Fraction(x) for i, x in enumerate(coeffs)
                         if x != 0})
    return [r for r in sorted(got, key=rx.ordered_key)
            for _ in range(got[r])]


def roots_cubic(coeffs: List) -> List:
    """sympy's ``roots_cubic(f, trig=False)`` of a cubic with rational
    coefficients (highest first), step by step in ``radexpr``'s
    arithmetic, every branch included."""
    lead = Fraction(coeffs[0])
    _, a, b, c = [Fraction(x) / lead for x in coeffs]
    if c == 0:
        x1, x2 = _multiple([1, a, b])
        return [x1, 0, x2]
    p = b - a ** 2 / 3
    q = c - a * b / 3 + 2 * a ** 3 / 27
    pon3, aon3 = p / 3, a / 3
    u1 = None
    if p == 0:
        if q == 0:
            return [_rational(-aon3)] * 3
        u1 = rx.mul(-1, rx.root(q, 3)) if q > 0 else rx.root(-q, 3)
    elif q == 0:
        y1, y2 = _multiple([1, 0, p])
        return [rx.add(t, -aon3) for t in (y1, 0, y2)]
    elif q < 0:
        u1 = rx.mul(-1, rx.root(rx.add(-q / 2, rx.sqrt(q ** 2 / 4 + pon3 ** 3)),
                                3))
    coeff = rx.mul(rx.mul(rx.I, rx.sqrt(3)), Fraction(1, 2))
    if u1 is None:
        units = [1, rx.add(Fraction(-1, 2), coeff),
                 rx.add(Fraction(-1, 2), rx.mul(-1, coeff))]
        D0 = a ** 2 - 3 * b
        D1 = 2 * a ** 3 - 9 * a * b + 27 * c
        C = rx.root(rx.mul(rx.add(D1, rx.sqrt(D1 ** 2 - 4 * D0 ** 3)),
                           Fraction(1, 2)), 3)
        out = []
        for uk in units:
            inner = rx.add(rx.add(a, rx.mul(uk, C)),
                           rx.mul(rx.mul(D0, rx.power(C, -1)),
                                  rx.power(uk, -1)))
            out.append(rx.mul(rx.mul(-1, inner), Fraction(1, 3)))
        return out
    us = [u1, rx.mul(u1, rx.add(Fraction(-1, 2), coeff)),
          rx.mul(u1, rx.add(Fraction(-1, 2), rx.mul(-1, coeff)))]
    if p == 0:
        return [rx.add(u, -aon3) for u in us]
    return [rx.add(rx.add(rx.mul(-1, u), rx.mul(pon3, rx.power(u, -1))),
                   -aon3) for u in us]


def _euler_resolvent_root(p: Fraction, q: Fraction,
                          r: Fraction) -> Optional[Fraction]:
    """The largest nonzero rational root of the Descartes–Euler resolvent
    64R³ + 32pR² + (4p² − 16r)R − q² of x⁴ + p·x² + q·x + r, else None."""
    res = _primitive([64, 32 * p, 4 * p * p - 16 * r, -q * q])
    xsols = [x for x, _ in _rational_roots(res)[0] if x != 0]
    return max(xsols) if xsols else None


def _euler(p: Fraction, q: Fraction, r: Fraction, a: Fraction):
    """``_roots_quartic_euler``: the Descartes–Euler roots of
    x⁴ + p·x² + q·x + r shifted by −a, where the resolvent has a nonzero
    rational root R (``_euler_resolvent_root``)."""
    R = _euler_resolvent_root(p, q, r)
    c1 = _sqrt(R)
    B = rx.mul(-q / (4 * R), c1)
    A = -R - p / 2
    c2, c3 = rx.sqrt(rx.add(A, B)), rx.sqrt(rx.add(A, rx.mul(-1, B)))
    neg = lambda x: rx.mul(-1, x)                           # noqa: E731
    return [rx.add(rx.add(c1, neg(c2)), -a),
            rx.add(rx.add(neg(c1), neg(c3)), -a),
            rx.add(rx.add(neg(c1), c3), -a),
            rx.add(rx.add(c1, c2), -a)]


def _depressed(coeffs: List) -> Tuple[Fraction, ...]:
    """a, b, c, d of the monic quartic x⁴ + a·x³ + b·x² + c·x + d and
    e, f, g of its depressed form y⁴ + e·y² + f·y + g (x = y − a/4)."""
    lead = Fraction(coeffs[0])
    _, a, b, c, d = [Fraction(x) / lead for x in coeffs]
    a2 = a * a
    e = b - 3 * a2 / 8
    f = c + a * (a2 / 8 - b / 2)
    g = d - a / 4 * (a * (3 * a2 / 64 - b / 4) + c)
    return a, b, c, d, e, f, g


def quartic_branch(coeffs: List) -> str:
    """The branch of ``roots_quartic`` that a quartic with rational
    coefficients (highest first) takes: ``zero root`` (d = 0),
    ``quasi-symmetric`` ((c/a)² = d), ``f = 0``, ``g = 0``, ``euler`` (the
    resolvent has a nonzero rational root), ``ferrari p = 0``, or Ferrari's
    cube root of r = −q/2 + √(q²/4 + p³/27): ``ferrari real`` where r is
    real and positive, ``ferrari complex`` where it is complex or
    negative (there sympy orders and branches the terms of the roots by
    the rounding noise of its ``evalf``, which the port does not emulate:
    ROADMAP.md queue 1 item 7)."""
    a, b, c, d, e, f, g = _depressed(coeffs)
    if d == 0:
        return "zero root"
    if a != 0 and (c / a) ** 2 == d:
        return "quasi-symmetric"
    if f == 0:
        return "f = 0"
    if g == 0:
        return "g = 0"
    if _euler_resolvent_root(e, f, g) is not None:
        return "euler"
    p = -e ** 2 / 12 - g
    q = -e ** 3 / 108 + e * g / 3 - f ** 2 / 8
    if p == 0:
        return "ferrari p = 0"
    if q * q / 4 + p ** 3 / 27 < 0 or (q > 0 and p < 0):
        return "ferrari complex"
    return "ferrari real"


def roots_quartic(coeffs: List) -> List:
    """sympy's ``roots_quartic`` of a quartic with rational coefficients
    (highest first), on every branch rational coefficients reach
    (``quartic_branch``; ``p`` rational, so no ``Piecewise``)."""
    branch = quartic_branch(coeffs)
    a, b, c, d, e, f, g = _depressed(coeffs)
    aon4 = a / 4
    if branch == "zero root":
        return [0] + _multiple([1, a, b, c])
    if branch == "quasi-symmetric":
        return _quasi_symmetric(a, b, c / a)
    if branch == "f = 0":
        y1, y2 = [rx.sqrt(t) for t in _multiple([1, e, g])]
        return [rx.add(t, -aon4)
                for t in (rx.mul(-1, y1), rx.mul(-1, y2), y1, y2)]
    if branch == "g = 0":
        return [rx.add(t, -aon4) for t in [0] + _multiple([1, 0, e, f])]
    if branch == "euler":
        return _euler(e, f, g, aon4)
    p = -e ** 2 / 12 - g
    q = -e ** 3 / 108 + e * g / 3 - f ** 2 / 8

    def ans(y):
        w = rx.sqrt(rx.add(e, rx.mul(2, y)))
        arg1 = rx.add(3 * e, rx.mul(2, y))
        arg2 = rx.mul(2 * f, rx.power(w, -1))
        out = []
        for s in (-1, 1):
            root = rx.sqrt(rx.mul(-1, rx.add(arg1, rx.mul(s, arg2))))
            for t in (-1, 1):
                half = rx.mul(rx.add(rx.mul(s, w), rx.mul(-t, root)),
                              Fraction(1, 2))
                out.append(rx.add(half, -aon4))
        return out

    if branch == "ferrari p = 0":
        return ans(rx.add(e * Fraction(-5, 6),
                          rx.mul(-1, rx.power(q, Fraction(1, 3)))))
    r = rx.add(-q / 2, rx.sqrt(q ** 2 / 4 + p ** 3 / 27))
    u = rx.power(r, Fraction(1, 3))
    y2 = rx.add(rx.add(e * Fraction(-5, 6), u),
                rx.mul(-1, rx.mul(rx.mul(p, rx.power(u, -1)),
                                  Fraction(1, 3))))
    return ans(y2)


def _quasi_symmetric(a: Fraction, b: Fraction, m: Fraction) -> List:
    """``roots_quartic``'s quasi-symmetric case x⁴ + a·x³ + b·x² + m·a·x + m²:
    the roots z1, z2 of z² + a·z + b − 2m, then those of x² − zᵢ·x + m
    (``roots_quadratic`` over EX where zᵢ is irrational)."""
    out = []
    for z in _quadratic(1, a, b - 2 * m):
        if isinstance(z, numbers.Rational):
            out += _quadratic(1, -z, m)
        else:
            out += _ex_quadratic(-z, m)
    return out


def _content(x) -> Fraction:
    """``Add.primitive``'s content: the gcd of the terms' numerators over
    the lcm of their denominators."""
    num, den = 0, 1
    for c in rx._terms(x).values():
        num = math.gcd(num, c.numerator)
        den = den * c.denominator // math.gcd(den, c.denominator)
    return Fraction(num, den)


def _ex_quadratic(b: Surd, c: Fraction) -> List:
    """``roots_quadratic`` of x² + b·x + c over EX with b = p + q·√k
    irrational: d = b² − 4c as ``simplify`` leaves it (the expanded number
    where ``count_ops`` finds it shorter than b² − 4c, else b's square
    kept, its content taken out and its sign made the rational part's
    positive), B = −b/2,
    D = factor_terms(√d/2), and B − D, B + D."""
    if b.d == -1:
        raise NotImplementedError(
            f"Polynomial.radical_roots: roots_quadratic over EX with the "
            f"Gaussian coefficient {cformat(b)} (whose square sympy's "
            f"simplify keeps or expands by rules not ported) ({_QUEUE})")
    expanded = b * b - 4 * c
    cb = _content(b)
    t = b / cb
    if t.p < 0:
        t = -t
    kept = rx.add(rx.mul(cb * cb, rx.power(t, 2)), -4 * c)
    orig = rx.add(rx.power(b, 2), -4 * c)
    d = expanded if rx.count_ops(expanded) < rx.count_ops(orig) else kept
    B = -b / 2
    if isinstance(d, numbers.Rational):
        D = _sqrt(Fraction(d)) / 2
    elif d is expanded:
        D = _ex_sqrt(d, Fraction(2))
    else:
        cd = _factor_terms_content(d)
        prim = rx.mul(Fraction(1) / cd, d)
        D = rx.mul(rx.mul(rx.sqrt(cd), Fraction(1, 2)), rx.sqrt(prim))
    return [rx.add(B, rx.mul(-1, D)), rx.add(B, D)]


def _unit_root(c: Fraction):
    """``exp(c·π·i).expand(complex=True)``: ±1 and ±i where 2c is an
    integer, else cos(c·π) + i·sin(c·π) with c taken into (−1, 1]."""
    c = Fraction(c) % 2
    if c > 1:
        c -= 2
    if (2 * c).denominator == 1:
        return {0: 1, 1: -1, Fraction(1, 2): rx.I,
                Fraction(-1, 2): rx.mul(-1, rx.I)}[c]
    return rx.expand(rx.add(rx.cos_pi(c), rx.mul(rx.sin_pi(c), rx.I)))


def roots_cyclotomic(f: List[int]) -> List:
    """sympy's ``roots_cyclotomic`` of Φ_n: exp(2πik/n) for k prime to n,
    in its order of k."""
    n = _cyclotomic_index(f)
    h = n // 2
    ks = [i for i in range(1, n + 1) if math.gcd(i, n) == 1]
    ks.sort(key=lambda x: (x, -1) if x <= h else (abs(x - n), 1))
    return [_unit_root(Fraction(2 * k, n)) for k in reversed(ks)]


def _surd_part(t) -> Optional[Tuple[Fraction, int]]:
    """(c, m) with t = c·√m (m = 1 for a rational), or None."""
    t = rx._terms(t)
    if not t:
        return Fraction(0), 1
    if len(t) != 1:
        return None
    (k, c), = t.items()
    pows, _, adds = k
    if adds or len(pows) > 1 or (pows and pows[0][1] != Fraction(1, 2)):
        return None
    return Fraction(c), (pows[0][0] if pows else 1)


def _complex_principal_root(base, n: int):
    """``root(base, n).expand(complex=True)`` for a complex base x + i·y
    (x, y rationals or rational multiples of one square root):
    |base|^(1/n)·(cos(θ/n) + i·sin(θ/n)) with θ = atan2(y, x), where atan
    evaluates θ (y/x one of ±1, ±√3, ±√3/3, or x = 0)."""
    terms = rx._terms(base)
    re_ = rx._number({k: c for k, c in terms.items() if not k[1]})
    im_ = rx._number({(k[0], False, k[2]): c for k, c in terms.items()
                      if k[1]})
    x, y = _surd_part(re_), _surd_part(im_)
    theta = None
    if x is not None and y is not None:
        mod2 = x[0] ** 2 * x[1] + y[0] ** 2 * y[1]
        r = _sqrt(mod2)
        if x[0] == 0:
            theta = Fraction(1 if y[0] > 0 else -1, 2)
        else:
            ratio = y[0] / x[0]              # y/x = ratio·√(my/mx)
            m = Fraction(y[1], x[1])
            table = {(1, 1): Fraction(1, 4), (3, 1): Fraction(1, 3),
                     (Fraction(1, 3), 1): Fraction(1, 6),
                     (1, 3): Fraction(1, 3), (1, Fraction(1, 3)): Fraction(1, 6)}
            key = (m, abs(ratio))
            if m == 3 and abs(ratio) == Fraction(1, 3):
                key = (Fraction(1, 3), 1)
            if key in table:
                theta = table[key] * (1 if ratio > 0 else -1)
                if x[0] < 0:
                    theta += 1 if y[0] > 0 else -1
    if theta is None:
        raise NotImplementedError(
            f"Polynomial.radical_roots: the principal root of "
            f"{cformat(base)} is written with atan, which is not ported "
            f"({_QUEUE})")
    # |base|^(1/n): sqrt(|base|²) to the 1/n, as Pow combines them
    rho = rx.power(r, Fraction(1, n)) if isinstance(r, numbers.Rational) \
        else rx.power(mod2, Fraction(1, 2 * n))
    return rx.expand(rx.add(rx.mul(rho, rx.cos_pi(theta / n)),
                            rx.mul(rx.mul(rho, rx.sin_pi(theta / n)), rx.I)))


def _binomial_roots(n: int, base) -> List:
    """``roots_binomial`` of xⁿ − base for a real exact ``base`` (a
    rational, a ``Surd`` or a ``Radical`` of known sign): alpha, the
    principal n-th root of base expanded into real and imaginary parts,
    times each n-th root of unity exp(2πik/n), expanded, in sympy's order
    of k."""
    facts = rx._add_facts(rx._terms(base))
    if facts.real is not True:
        alpha, neg = _complex_principal_root(base, n), False
    elif not facts.pos and not facts.neg:
        raise NotImplementedError(
            f"Polynomial.radical_roots: roots_binomial of a base whose sign "
            f"sympy does not decide ({cformat(base)}) is not ported "
            f"({_QUEUE})")
    else:
        neg = bool(facts.neg)
        if n == 2:
            alpha = rx.mul(rx.I, rx.sqrt(rx.mul(-1, base))) if neg \
                else rx.sqrt(base)
        else:
            rho = rx.root(rx.mul(-1, base) if neg else base, n)
            alpha = rho
            if neg:
                cos_a = rx.cos_pi(Fraction(1, n))
                sin_a = rx.sin_pi(Fraction(1, n))
                alpha = rx.expand(rx.add(rx.mul(rho, cos_a),
                                         rx.mul(rx.mul(rho, sin_a), rx.I)))
    ks, imax = [], n // 2           # sympy's order of k
    if n % 2 == 0:
        ks.append(imax)
        imax -= 1
    if not neg:
        ks.append(0)
    for i in range(imax, 0, -1):
        ks.extend([i, -i] if neg else [-i, i])
    if neg:
        ks.append(0)
    out = []
    for k in ks:
        out.append(rx.expand(rx.expand_mul(alpha,
                                           _unit_root(Fraction(2 * k, n)))))
    return out


def _binomial(c: List[int]) -> List:
    """``roots_binomial`` of ``a·xⁿ + b`` (``roots_quadratic`` at n = 2):
    every n-th root of ``-b/a``, in sympy's order of k."""
    n = len(c) - 1
    if n == 2:
        return _quadratic(c[0], 0, c[2])
    return _binomial_roots(n, Fraction(-c[-1], c[0]))


def _factor_roots(f: List[int]) -> List:
    """``_try_heuristics`` on one irreducible factor of ``factor_list``: its
    roots, or none for a factor of degree ≥ 5 that sympy has no formula for
    (``quintics=False``)."""
    n = len(f) - 1
    if n == 1:
        return [_rational(Fraction(-f[1], f[0]))]
    if sum(1 for x in f if x != 0) == 2:
        return _binomial(f)
    if n == 2:
        return _quadratic(*f)
    if _cyclotomic_index(f):
        return roots_cyclotomic(f)
    if n == 3:
        return roots_cubic(f)
    if n == 4:
        return roots_quartic(f)
    return []


def _factor_terms_content(x) -> Fraction:
    """The content ``factor_terms`` (``clear=False``) takes out of a sum:
    ``_content``, but only its numerator where a term of x over it keeps
    an integer coefficient."""
    c = _content(x)
    if c.denominator != 1 and any(
            (v / c.numerator).denominator == 1 for v in rx._terms(x).values()):
        return Fraction(c.numerator)
    return c


def _ex_sqrt(d, A: Fraction, signsimp: bool = False):
    """``factor_terms(sqrt(d)/A)`` in ``roots_quadratic`` over EX, for
    d = p + q·√k: the positive rational content c of d taken out of the
    root (sqrt(c) a coefficient and a numeric root), and the imaginary
    unit where both terms of a real d are negative; with ``signsimp``
    (``_try_heuristics`` ``cancel``s the roots, whose ``signsimp`` takes
    −1 out of a sum with a negative rational part), also where the
    rational part alone is negative and d's value is."""
    if isinstance(d, Surd) and d.p == 0 and d.d > 0:
        # sqrt(q·√k) = |q|^(1/2)·k^(1/4), times i for q < 0
        out = rx.mul(rx.mul(rx.sqrt(abs(d.q)), rx.root(d.d, 4)),
                     Fraction(1) / A)
        return rx.mul(out, rx.I) if d.q < 0 else out
    if not isinstance(d, Surd) or d.p == 0:
        raise NotImplementedError(
            f"Polynomial.radical_roots: roots_quadratic over EX with the "
            f"discriminant {cformat(d)} is not ported ({_QUEUE})")
    c = _factor_terms_content(d)
    t = d / c
    imag = d.d > 0 and t.p < 0 and (t.q < 0 or (
        signsimp and not rx._add_facts(rx._terms(t)).pos))
    if imag:
        t = -t
    if t.d == -1 and isinstance(_sqrt(t.p ** 2 + t.q ** 2), numbers.Rational):
        raise NotImplementedError(
            f"Polynomial.radical_roots: the square root of the Gaussian "
            f"number {t.cformat()} is not ported ({_QUEUE})")
    out = rx.mul(rx.mul(rx.sqrt(c), Fraction(1) / A), rx.sqrt(t))
    return rx.mul(out, rx.I) if imag else out


def _ex_heuristics(h: List[Fraction], r) -> List:
    """``_try_heuristics`` of h − r (h monic with no constant term, r a root
    of the outer component): a binomial's roots where h is a monomial,
    else ``roots_quadratic`` over EX."""
    n = len(h) - 1
    if all(x == 0 for x in h[1:]):
        return _binomial_roots(n, r)
    if n == 2:
        b = h[1]
        d = rx.add(b * b, rx.mul(4, r))
        B = _rational(-b / 2)
        D = _ex_sqrt(d, Fraction(2), signsimp=True)
        return [rx.add(B, rx.mul(-1, D)), rx.add(B, D)]
    raise NotImplementedError(
        f"Polynomial.radical_roots: the roots of a degree-{n} inner "
        f"component over EX are not ported ({_QUEUE})")


def _try_decompose(c: List[int]) -> List:
    """``_try_decompose`` on a polynomial irreducible over ℚ: the roots of
    the outer component g (``_try_heuristics``), then for each inner
    component h in turn, the roots of h − r for each root r so far."""
    chain = _decompose(c)
    roots = _factor_roots(_positive(chain[0]))
    for h in chain[1:]:
        roots = [x for r in roots for x in _ex_heuristics(h, r)]
    return roots


def _vanishing_factor(root: Any, factors: List[List[int]]) -> List[int]:
    """The one factor that vanishes at ``root`` (a root of their product),
    told apart at 40 digits."""
    re_, im_ = root.value(50)
    with localcontext() as ctx:
        ctx.prec = 50
        hits = []
        for f in factors:
            a, b = Decimal(0), Decimal(0)
            for x in f:
                a, b = a * re_ - b * im_ + x, a * im_ + b * re_
            if abs(a) + abs(b) < Decimal(10) ** -40 * max(abs(x) for x in f):
                hits.append(f)
    if len(hits) != 1:
        raise ArithmeticError(f"{root} is a root of {len(hits)} of the "
                              f"factors {factors}")
    return hits[0]


def radical_roots(powers: Dict[int, Any]) -> Dict[Any, int]:
    """``{root: multiplicity}`` of ``Σ c_e·x^e`` in sympy's order, the
    coefficients rational, or rational and float (sympy's RR: ``nroots``).
    Where sympy has no formula for a factor, its roots are left out, as
    ``sympy.roots`` leaves them out: the result is then partial, or
    empty."""
    if not powers:
        return {}
    if not all(isinstance(c, numbers.Rational) for c in powers.values()):
        if not nroots.is_real_float(powers.values()):
            raise NotImplementedError(
                "Polynomial.radical_roots: coefficients other than rational "
                "and float ones (sympy's EX domain) are not ported "
                f"({_QUEUE})")
        return nroots.float_roots(powers)
    low = min(powers)
    zeros = {0: low} if low else {}
    deg = max(powers) - low
    coeffs = _primitive([powers.get(e, 0) for e in range(max(powers),
                                                         low - 1, -1)])
    basis = _integer_basis(coeffs) if deg > 0 else None
    if basis:
        coeffs = [x // basis ** i for i, x in enumerate(coeffs)]
    found: List[Tuple[Any, int, List[int]]] = []   # root, mult, its factor

    def put(roots, factor, mult=1):
        found.extend((r, mult, factor) for r in roots)

    nonzero = sum(1 for x in coeffs if x != 0)
    if deg == 1:
        put([_rational(Fraction(-coeffs[1], coeffs[0]))], coeffs)
    elif deg == 2 and nonzero == 2:
        put(_quadratic(coeffs[0], 0, coeffs[2]), coeffs)
    elif deg >= 3 and nonzero == 2:
        # sympy takes a binomial's roots without factoring it; a Radical
        # root's own factor is the one that vanishes there
        factors = [f for f, _ in _factor_list(coeffs)]
        for r in _binomial(coeffs):
            put([r], coeffs if len(factors) == 1 or not isinstance(
                r, rx.Radical) else _vanishing_factor(r, factors))
    elif deg >= 2:
        factors = _factor_list(coeffs)
        if len(factors) == 1 and deg == 2:
            put(_quadratic(*coeffs), coeffs)
        elif len(factors) == 1 and factors[0][1] == 1:
            put(_try_decompose(coeffs), coeffs)
        else:
            for f, m in factors:
                put(_factor_roots(f), f, m)
    result: Dict[Any, int] = {}
    for r, m, f in found:
        if basis:
            r = rx.mul(basis, r)
            f = [x * basis ** i for i, x in enumerate(f)]
        if isinstance(r, rx.Radical):
            r.minpoly = tuple(_positive(f))
        result[r] = result.get(r, 0) + m
    result.update(zeros)
    return result
