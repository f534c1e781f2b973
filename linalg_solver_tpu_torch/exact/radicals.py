"""Exact roots of rational polynomials: the port's counterpart of the
JAX package's ``sympy.roots(poly, multiple=False)``
(``linalg_solver_tpu.exact.polynomial.Polynomial.radical_roots``).

A root is a rational (``int`` or ``Fraction``), a ``Surd`` ``p + q·√d``
(d a squarefree integer, d < 0 for ``i·√|d|``), which prints as
``sympy.latex`` prints the same number (``utils.fmt.latex_surd``), or a
``radexpr.Radical``: the roots ``roots_cubic`` (``trig=False``) writes for
an irreducible cubic, and those ``roots_binomial`` writes for a·xⁿ + b at
n = 3, 4, 6 (and 8 where -b/a > 0), built step by step as sympy builds
them.

The order of the returned dict is sympy's, which the LaTeX text shows:
``roots`` strips the zero roots (added back last), makes the polynomial a
primitive integer one, rescales x by ``_integer_basis``, then takes a
linear polynomial's root, a binomial's roots (``roots_quadratic`` at
degree 2, else ``roots_binomial``'s order of the n-th roots), a lone
quadratic's two roots, an irreducible polynomial's roots through
``_try_decompose``, or each factor's roots in the order of ``factor_list``
(``_sort_factors``: by length, multiplicity, then the coefficient list).
A quadratic's roots come as ``B - |D|``, ``B + |D|``.

As in sympy (``quintics=False``), a factor of degree ≥ 5 that is neither a
binomial nor cyclotomic has no roots here: the dict is then partial, or
empty.  The factors come from subsets of float roots, each checked by
exact division, so such a factor is first proved irreducible modulo
primes.  What sympy writes in forms not ported raises
``NotImplementedError`` citing ROADMAP.md queue 1 item 7: ``roots_quartic``,
``roots_cyclotomic`` (cosines of π/n), binomials of other degrees,
decompositions into nested radicals, and a factor that no prime proves
irreducible (an exact factorization over ℤ is not ported).
"""

from __future__ import annotations

import cmath
import itertools
import math
import numbers
from decimal import Decimal, localcontext
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


def _factor_of_size(c: List[int], roots, k: int) -> Optional[List[int]]:
    """A factor of c over ℤ of degree k, from the products of k of its
    float roots closed under conjugation; each candidate is checked by
    exact division."""
    lead = abs(c[0])
    for idx in itertools.combinations(range(len(roots)), k):
        prod = np.poly(roots[list(idx)])
        if np.max(np.abs(prod.imag)) > 1e-6 * (1 + np.max(np.abs(prod))):
            continue
        for a in _divisors(lead):
            cand = [int(round(a * x)) for x in prod.real]
            if cand[-1] == 0 or any(
                    abs(a * x - y) > 1e-5 * (1 + abs(y))
                    for x, y in zip(prod.real, cand)):
                continue
            if _divides(c, cand) is not None:
                return cand
    return None


def _irreducible_factors(c: List[int]) -> List[List[int]]:
    """The irreducible factors over ℤ of a squarefree integer polynomial
    without rational roots (positive leading coefficients)."""
    found = []
    while len(c) > 3:
        roots = np.roots(np.array([float(x) for x in c]))
        f = None
        for k in range(2, (len(c) - 1) // 2 + 1):
            f = _factor_of_size(c, roots, k)
            if f is not None:
                break
        if f is None:
            break
        found.append(_positive(f))
        c = _primitive(_divides(c, f))
    if len(c) >= 3:
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
            for f in _irreducible_factors(_primitive(part)):
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
# Irreducibility proved modulo primes
# ---------------------------------------------------------------------------

def _mod_divmod(a: List[int], b: List[int], p: int
                ) -> Tuple[List[int], List[int]]:
    """Long division of integer lists mod p (b's leading term a unit);
    the zero polynomial is ``[]``."""
    a, inv, q = list(a), pow(b[0], -1, p), []
    while len(a) >= len(b):
        c = a[0] * inv % p
        q.append(c)
        for i, x in enumerate(b):
            a[i] = (a[i] - c * x) % p
        a.pop(0)
    return q, _mod_trim(a)


def _mod_trim(a: List[int]) -> List[int]:
    i = 0
    while i < len(a) and a[i] == 0:
        i += 1
    return a[i:]


def _mod_mul(a: List[int], b: List[int], p: int) -> List[int]:
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % p
    return out


def _mod_sub(a: List[int], b: List[int], p: int) -> List[int]:
    n = max(len(a), len(b))
    a, b = [0] * (n - len(a)) + a, [0] * (n - len(b)) + b
    return _mod_trim([(x - y) % p for x, y in zip(a, b)])


def _mod_gcd(a: List[int], b: List[int], p: int) -> List[int]:
    while b:
        a, b = b, _mod_divmod(a, b, p)[1]
    return a


def _degree_pattern(f: List[int], p: int) -> List[int]:
    """The degrees of f's irreducible factors mod p (f squarefree mod p,
    its leading coefficient a unit), by distinct-degree factorization:
    the product of the factors of degree d is gcd(f, x^(p^d) − x)."""
    degrees, h, d = [], [1, 0], 0
    while len(f) - 1 >= 2 * (d + 1):
        d += 1
        power, base, e = [1], h, p                  # h ← h^p mod f
        while e:
            if e & 1:
                power = _mod_divmod(_mod_mul(power, base, p), f, p)[1]
            base = _mod_divmod(_mod_mul(base, base, p), f, p)[1]
            e >>= 1
        h = power
        g = _mod_gcd(f, _mod_sub(h, [1, 0], p), p)
        if len(g) > 1:
            degrees += [d] * ((len(g) - 1) // d)
            f = _mod_divmod(f, g, p)[0]
            h = _mod_divmod(h, f, p)[1]
    if len(f) > 1:
        degrees.append(len(f) - 1)
    return degrees


def _primes(count: int) -> List[int]:
    out, k = [], 2
    while len(out) < count:
        if all(k % q for q in out if q * q <= k):
            out.append(k)
        k += 1
    return out


def _proven_irreducible(f: List[int]) -> bool:
    """Whether f is proved irreducible over ℚ: a factor over ℚ of degree
    k reduces mod every prime p (not dividing f's leading coefficient,
    f squarefree mod p) to a product of some of f's factors mod p, so k
    is a sum of some of their degrees at every such p.  Proved once no k
    in 1..n−1 is left over the first 60 primes."""
    n = len(f) - 1
    possible = set(range(1, n))
    for p in _primes(60):
        fp = [x % p for x in f]
        if fp[0] == 0:
            continue
        deriv = _mod_trim([x * (n - i) % p for i, x in enumerate(fp[:-1])])
        if len(_mod_gcd(fp, deriv, p)) != 1:
            continue
        sums = {0}
        for d in _degree_pattern(fp, p):
            sums |= {s + d for s in sums}
        possible &= sums
        if not possible:
            return True
    return False


# ---------------------------------------------------------------------------
# Cyclotomic and composed polynomials (what sympy's dispatch tests)
# ---------------------------------------------------------------------------

def _cyclotomic(m: int) -> List[int]:
    """Φ_m, highest degree first."""
    num = [1] + [0] * (m - 1) + [-1]
    for d in range(1, m):
        if m % d == 0:
            num = [int(x) for x in _divmod(num, _cyclotomic(d))[0]]
    return num


def _is_cyclotomic(f: List[int]) -> bool:
    """``Poly.is_cyclotomic`` of an irreducible factor: monic with a ±1
    constant term and equal to some Φ_m."""
    if f[0] != 1 or f[-1] not in (1, -1):
        return False
    n = len(f) - 1
    phi = lambda m: sum(1 for k in range(1, m + 1) if math.gcd(k, m) == 1)
    return any(phi(m) == n and _cyclotomic(m) == list(f)
               for m in range(1, 4 * n * n + 3))


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


def _outer_component(f: List[int]) -> Optional[List[Fraction]]:
    """``Poly.decompose()[0]`` where f decomposes (sympy peels the right
    factor of least degree until none is left), else None."""
    g = [Fraction(x) for x in f]
    peeled = False
    while True:
        df = len(g) - 1
        for s in range(2, df):
            if df % s:
                continue
            h = _right_decompose(g, s)
            outer = _left_decompose(g, h)
            if outer is not None:
                g, peeled = outer, True
                break
        else:
            return g if peeled else None


def _solvable(f: List) -> bool:
    """Whether ``_try_heuristics`` has a formula for f (an irreducible
    factor): all but a non-binomial, non-cyclotomic factor of degree ≥ 5,
    for which it returns no roots."""
    n = len(f) - 1
    if n <= 4 or sum(1 for x in f if x != 0) == 2:
        return True
    return all(Fraction(x).denominator == 1 for x in f) and \
        _is_cyclotomic([int(x) for x in f])


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


def _cos_sin(deg: Fraction) -> Tuple[Any, Any]:
    """cos and sin of ``deg`` degrees (a multiple of 30 or 45), exactly as
    sympy evaluates them."""
    deg = Fraction(deg) % 360
    half3 = rx.mul(rx.sqrt(3), Fraction(1, 2))
    half2 = rx.mul(rx.sqrt(2), Fraction(1, 2))
    table = {0: (1, 0), 30: (half3, Fraction(1, 2)), 45: (half2, half2),
             60: (Fraction(1, 2), half3), 90: (0, 1)}
    ref = deg % 180
    if ref > 90:
        c, s = table[180 - ref]
        c = rx.mul(-1, c)
    else:
        c, s = table[ref]
    if deg >= 180:
        c = rx.mul(-1, c)
        s = rx.mul(-1, s)
    return c, s


def _binomial_radicals(c: List[int]) -> List:
    """``roots_binomial`` of ``a·xⁿ + b`` (n = 3, 4, 6, 8): alpha, the
    principal n-th root of ``-b/a`` expanded into real and imaginary parts,
    times each n-th root of unity, expanded."""
    n = len(c) - 1
    base = Fraction(-c[-1], c[0])
    rho = rx.root(abs(base), n)
    if base > 0:
        alpha = rho
    else:
        cos_a, sin_a = _cos_sin(Fraction(180, n))
        alpha = rx.add(rx.mul(rho, cos_a),
                       rx.mul(rx.mul(rho, sin_a), rx.I))
    neg = base < 0
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
        cz, sz = _cos_sin(Fraction(360 * k, n))
        zeta = rx.add(cz, rx.mul(sz, rx.I))
        out.append(rx.expand_mul(alpha, zeta))
    return out


def _binomial(c: List[int]) -> List:
    """``roots_binomial`` of ``a·xⁿ + b``: every n-th root of ``-b/a``, in
    sympy's order of k (the root ``alpha·exp(2πik/n)``, alpha the
    principal root), where sympy writes it in square and n-th roots: at
    n = 2, 3, 4, 6, and at n = 8 for a positive ``-b/a``."""
    n = len(c) - 1
    if n == 2:
        return _quadratic(c[0], 0, c[2])
    if n in (3, 4, 6) or (n == 8 and Fraction(-c[-1], c[0]) > 0):
        return _binomial_radicals(c)
    raise NotImplementedError(
        f"Polynomial.radical_roots: the roots of a binomial of degree {n} "
        f"need cosines of pi/{2 * n}, which are not ported ({_QUEUE})")


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
    if _is_cyclotomic(f):
        raise NotImplementedError(
            f"Polynomial.radical_roots: roots_cyclotomic (cosines of pi/n) "
            f"of a cyclotomic factor of degree {n} is not ported ({_QUEUE})")
    if n == 3:
        return roots_cubic(f)
    if n == 4:
        raise NotImplementedError(
            f"Polynomial.radical_roots: roots_quartic of an irreducible "
            f"quartic factor is not ported ({_QUEUE})")
    return _unsolved(f)


def _unsolved(f: List[int]) -> List:
    """No roots for a factor of degree ≥ 5 that sympy has no formula for,
    once f is proved irreducible (else the float-root search may have
    missed a factor whose roots sympy writes)."""
    if not _proven_irreducible(f):
        raise NotImplementedError(
            f"Polynomial.radical_roots: {f} is not proved irreducible over "
            f"Q (no prime's factor degrees rule out a factor), and an exact "
            f"factorization over Z is not ported ({_QUEUE})")
    return []


def _single_irreducible(c: List[int]) -> List:
    """``_try_decompose`` on a polynomial irreducible over ℚ: a composed
    polynomial whose outer component has a formula gives nested radicals
    (not ported); one whose outer component has none gives no roots."""
    outer = _outer_component(c)
    if outer is None:
        return _factor_roots(c)
    if not _solvable(outer):
        return _unsolved(c)
    raise NotImplementedError(
        f"Polynomial.radical_roots: a decomposition of a degree-"
        f"{len(c) - 1} polynomial into nested radicals is not ported "
        f"({_QUEUE})")


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
    coefficients rational.  Where sympy has no formula for a factor, its
    roots are left out, as ``sympy.roots`` leaves them out: the result is
    then partial, or empty."""
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
            put(_single_irreducible(coeffs), coeffs)
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
