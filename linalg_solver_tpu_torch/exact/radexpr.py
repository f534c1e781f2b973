"""Exact radical numbers as sympy builds them: the port's counterpart of
the expressions that ``sympy.roots`` returns for cubics
(``roots_cubic``, ``trig=False``) and binomials (``roots_binomial``) of a
rational polynomial, with no sympy.

A ``Radical`` is a sum of terms; a term is a rational coefficient times
numeric powers ``b**e`` (b a positive integer, e a non-integral rational),
optionally the imaginary unit, and powers of sums (``(p + q√d)**(1/3)``,
``(-1/2 + √3·i/2)**-1``).  The constructors below apply sympy's automatic
evaluation for exactly these shapes:

- ``Integer._eval_power`` / ``Rational._eval_power`` for a rational to a
  rational power (``root(12, 3)`` stays ``12**(1/3)``, ``root(16, 3)`` is
  ``2*2**(1/3)``, ``2**(-2/3)`` is ``2**(1/3)/2``);
- ``Mul.flatten``'s numeric powers (``2**(1/3)*sqrt(2)`` is ``2**(5/6)``,
  ``sqrt(2)*sqrt(6)`` is ``2*sqrt(3)``), ``I*I = -1``, powers of one sum
  add their exponents, a rational times a sum distributes;
- ``Add.flatten``'s collection of like terms.

``cformat`` is ``sympy.latex`` of the same expression: terms in
``Expr.as_ordered_terms`` order (numeric values: real terms first, then by
imaginary and real part), factors in ``sort_key`` order, the
numerator/denominator split of ``LatexPrinter._print_Mul`` and the root
notation of ``_print_Pow``.  Equality and hashing are structural, as sympy
compares dict keys.  A result of the form ``p + q·√d`` comes back as a
``radicals.Surd`` and a rational one as ``int``/``Fraction``, so keys
compare equal across the two types.
"""

from __future__ import annotations

import math
import numbers
import re
from decimal import Decimal, localcontext
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

_I = "I"                                    # the imaginary unit's factor key
_NUMBER = (1, 0, "Number")                  # sympy class keys
_ATOM_I = (2, 0, "ImaginaryUnit")
_MUL = (3, 0, "Mul")
_ADD = (3, 1, "Add")
_PREC = 60                                  # decimal digits of ``value``


def _rat(x) -> Any:
    """A rational as sympy keeps it: an int where it is integral."""
    x = Fraction(x)
    return int(x) if x.denominator == 1 else x


# ---------------------------------------------------------------------------
# Integers to rational powers (sympy's Integer/Rational._eval_power)
# ---------------------------------------------------------------------------

def _nthroot(n: int, k: int) -> Tuple[int, bool]:
    """``integer_nthroot``: (floor of the k-th root of n, exact?)."""
    if n < 2:
        return n, True
    x = int(round(n ** (1.0 / k)))
    for cand in (x - 1, x, x + 1):
        if cand >= 0 and cand ** k == n:
            return cand, True
    while x ** k > n:
        x -= 1
    while (x + 1) ** k <= n:
        x += 1
    return x, False


def _perfect_power(n: int):
    """``perfect_power(n)``: (b, e) with n = b**e and e largest, or False."""
    if n < 4:
        return False
    for e in range(n.bit_length(), 1, -1):
        b, exact = _nthroot(n, e)
        if exact and b > 1:
            return b, e
    return False


def _factors(n: int) -> Dict[int, int]:
    """``Integer(n).factors(limit=2**15)``: trial division to 2**15, the
    cofactor kept whole."""
    out: Dict[int, int] = {}
    f = 2
    while f * f <= n and f <= 2 ** 15:
        while n % f == 0:
            out[f] = out.get(f, 0) + 1
            n //= f
        f += 1 if f == 2 else 2
    if n > 1:
        out[n] = out.get(n, 0) + 1
    return out


# A numeric monomial: (coefficient, [(base, exponent), ...], imaginary unit?)
Mono = Tuple[Fraction, List[Tuple[int, Fraction]], bool]


def _int_pow(b: int, e: Fraction) -> Optional[Mono]:
    """``Integer(b)**e`` for a non-integral rational e: the evaluated
    monomial, or None where sympy leaves ``Pow(b, e)``."""
    if b < 0:
        if e == Fraction(1, 2):
            c, pows, im = _pow_mono(-b, e)
            return c, pows, not im
        raise NotImplementedError(
            f"radexpr: ({b})**({e}) is not one of sympy's shapes here")
    if e < 0:
        return _rat_pow(Fraction(1, b), -e)
    x, exact = _nthroot(b, e.denominator)
    if exact:
        return Fraction(x ** e.numerator), [], False
    pp = _perfect_power(b)
    fac = {pp[0]: pp[1]} if pp else _factors(b)
    out_int, out_rad, sqr = 1, [], {}
    for prime, exponent in fac.items():
        exponent *= e.numerator
        div_e, div_m = divmod(exponent, e.denominator)
        if div_e > 0:
            out_int *= prime ** div_e
        if div_m > 0:
            g = math.gcd(div_m, e.denominator)
            if g != 1:
                out_rad.append((prime, Fraction(div_m // g,
                                                e.denominator // g)))
            else:
                sqr[prime] = div_m
    sqr_gcd = 0
    for ex in sqr.values():
        sqr_gcd = ex if sqr_gcd == 0 else math.gcd(sqr_gcd, ex)
        if sqr_gcd == 1:
            break
    sqr_int = 1
    for k, v in sqr.items():
        sqr_int *= k ** (v // sqr_gcd)
    if sqr_int == b and out_int == 1 and not out_rad:
        return None
    # out_int*out_rad*Pow(sqr_int, sqr_gcd/q), one binary product at a time
    acc: Mono = (Fraction(1), [], False)
    for prime, x in out_rad:
        acc = _times(acc, _pow_mono(prime, x))
    acc = _times((Fraction(out_int), [], False), acc)
    if sqr_int != 1 and sqr_gcd:
        acc = _times(acc, _pow_mono(sqr_int, Fraction(sqr_gcd,
                                                      e.denominator)))
    return acc


def _rat_pow(r: Fraction, e: Fraction) -> Mono:
    """``Rational(r)**e`` (r > 0), as ``Rational._eval_power``."""
    r = Fraction(r)
    if r.denominator == 1:
        return _pow_mono(r.numerator, e)
    if e < 0:
        if e == -1:
            return Fraction(1) / r, [], False
        return _rat_pow(1 / r, -e)
    if e.denominator == 1:
        return r ** e.numerator, [], False
    p, q = r.numerator, r.denominator
    intpart = e.numerator // e.denominator
    if intpart:
        intpart += 1
        frac = Fraction(intpart * e.denominator - e.numerator, e.denominator)
        tail = Fraction(1, q ** intpart)
    else:
        frac = Fraction(e.denominator - e.numerator, e.denominator)
        tail = Fraction(1, q)
    acc = _pow_mono(q, frac)
    if p != 1:
        acc = _times(_pow_mono(p, e), acc)
    return _times(acc, (tail, [], False))


def _seq(m: Mono) -> List[Any]:
    """A monomial's factors in sympy's argument order (``_mulsort``:
    numeric powers by base), as ``Mul.flatten`` meets them."""
    c, pows, imag = m
    return [c] + [("pow", b, e) for b, e in sorted(pows)] + \
        ([_I] if imag else [])


def _times(a: Mono, b: Mono) -> Mono:
    """``a*b``: one ``Mul.flatten`` of a's arguments, then b's."""
    return _mul_numeric(_seq(a) + _seq(b))


def _settled(m: Mono) -> Mono:
    """A monomial flattened again until it no longer changes, as
    ``expand`` leaves it (``fraction`` and ``n/d`` rebuild each term)."""
    for _ in range(6):
        again = _mul_numeric(_seq(m))
        if again == m:
            break
        m = again
    return m


def _pow_mono(b: int, e: Fraction) -> Mono:
    """``Pow(b, e)`` evaluated, as a monomial."""
    e = Fraction(e)
    if b == 1 or e == 0:
        return Fraction(1), [], False
    if e.denominator == 1:
        return Fraction(b) ** e.numerator, [], False
    got = _int_pow(b, e)
    return got if got is not None else (Fraction(1), [(b, e)], False)


def _mul_numeric(seq: List[Any]) -> Mono:
    """The numeric part of ``Mul.flatten``: rationals, ``"I"`` and
    ``("pow", b, e)`` factors (b a positive integer) to one monomial."""
    coeff = Fraction(1)
    neg1e = Fraction(0)
    pnum_rat: Dict[int, List[Fraction]] = {}
    seq = list(seq)
    i = 0
    while i < len(seq):
        o = seq[i]
        i += 1
        if o == _I:
            neg1e += Fraction(1, 2)
        elif isinstance(o, tuple):
            _, b, e = o
            if e.denominator == 1:
                coeff *= Fraction(b) ** e.numerator
            elif e < 0:
                c, pows, im = _pow_mono(b, e)
                seq += [c] + [("pow", pb, pe) for pb, pe in pows]
                if im:
                    seq.append(_I)
            elif b != 1:
                pnum_rat.setdefault(b, []).append(e)
        else:
            coeff *= Fraction(o)
    comb_e: Dict[Fraction, List[int]] = {}
    for b, es in pnum_rat.items():
        comb_e.setdefault(sum(es, Fraction(0)), []).append(b)
    num_rat: List[Tuple[int, Fraction]] = []
    for e, bs in comb_e.items():
        b = math.prod(bs)
        if e.denominator == 1:
            coeff *= Fraction(b) ** e.numerator
            continue
        if e.numerator > e.denominator:
            e_i, ep = divmod(e.numerator, e.denominator)
            coeff *= Fraction(b) ** e_i
            e = Fraction(ep, e.denominator)
        num_rat.append((b, e))
    pnew: Dict[Fraction, List[int]] = {}
    i = 0
    while i < len(num_rat):
        bi, ei = num_rat[i]
        if bi == 1:
            i += 1
            continue
        grow = []
        for j in range(i + 1, len(num_rat)):
            bj, ej = num_rat[j]
            g = math.gcd(bi, bj)
            if g != 1:
                e = ei + ej
                if e.denominator == 1:
                    coeff *= Fraction(g) ** e.numerator
                else:
                    if e.numerator > e.denominator:
                        e_i, ep = divmod(e.numerator, e.denominator)
                        coeff *= Fraction(g) ** e_i
                        e = Fraction(ep, e.denominator)
                    grow.append((g, e))
                num_rat[j] = (bj // g, ej)
                bi //= g
                if bi == 1:
                    break
        if bi != 1:
            c, pows, _ = _pow_mono(bi, ei)
            coeff *= c
            for pb, pe in pows:
                pnew.setdefault(pe, []).append(pb)
        num_rat.extend(grow)
        i += 1
    imag = False
    if neg1e:
        n, p = divmod(neg1e.numerator, neg1e.denominator)
        if n % 2:
            coeff = -coeff
        if neg1e.denominator == 2:
            imag = True
    out: List[Tuple[int, Fraction]] = []
    for e, bs in pnew.items():
        c, pows, _ = _pow_mono(math.prod(bs), e)
        coeff *= c
        out += pows
    return coeff, sorted(out), imag


# ---------------------------------------------------------------------------
# Terms and sums
# ---------------------------------------------------------------------------

# A term's key: (numeric powers sorted by base, imaginary unit?, powers of
# sums as a frozenset of (Radical, exponent)); the empty key is the
# rational constant.
Key = Tuple[Tuple[Tuple[int, Fraction], ...], bool, frozenset]
_ONE_KEY: Key = ((), False, frozenset())
Terms = Dict[Key, Fraction]


def _terms(x) -> Terms:
    """The sum of terms of a rational, a ``Surd`` or a ``Radical``."""
    if isinstance(x, Radical):
        return dict(x.terms)
    if isinstance(x, numbers.Rational):
        return {_ONE_KEY: Fraction(x)} if x != 0 else {}
    from .radicals import Surd
    if isinstance(x, Surd):
        out = {_ONE_KEY: x.p} if x.p != 0 else {}
        pows = ((abs(x.d), Fraction(1, 2)),) if abs(x.d) != 1 else ()
        out[(pows, x.d < 0, frozenset())] = x.q
        return out
    raise TypeError(f"radexpr: {x!r} is not an exact radical number")


def _number(terms: Terms):
    """The canonical number of a sum: a rational, a ``Surd`` where it is
    ``p + q·√d``, else a ``Radical``."""
    terms = {k: c for k, c in terms.items() if c != 0}
    if not terms:
        return 0
    if set(terms) == {_ONE_KEY}:
        return _rat(terms[_ONE_KEY])
    rest = [k for k in terms if k != _ONE_KEY]
    if len(rest) == 1:
        pows, imag, adds = rest[0]
        if not adds and (not pows or (len(pows) == 1
                                      and pows[0][1] == Fraction(1, 2))):
            if pows or imag:
                from .radicals import Surd
                d = pows[0][0] if pows else 1
                return Surd(terms.get(_ONE_KEY, Fraction(0)), terms[rest[0]],
                            -d if imag else d)
    return Radical(terms)


def _mul_keys(c1: Fraction, k1: Key, c2: Fraction, k2: Key) -> Tuple[Fraction, Key]:
    """``Mul.flatten`` of two terms: the numeric factors through
    ``_mul_numeric``, the powers of sums by adding exponents."""
    seq = _seq((c1, list(k1[0]), k1[1])) + _seq((c2, list(k2[0]), k2[1]))
    coeff, pows, imag = _mul_numeric(seq)
    adds: Dict[Radical, Fraction] = {}
    for _, _, a in (k1, k2):
        for base, e in a:
            adds[base] = adds.get(base, Fraction(0)) + e
    adds = {b: e for b, e in adds.items() if e != 0}
    return coeff, (tuple(pows), imag, frozenset(adds.items()))


def _as_factor(t: Terms) -> Tuple[Fraction, Key]:
    """A sum as one factor of a product: a lone term as it is, a sum of
    several as the power ``(sum)**1``."""
    if len(t) == 1:
        (k, c), = t.items()
        return c, k
    return Fraction(1), ((), False, frozenset({(Radical(t), Fraction(1))}))


def _distributed(c: Fraction, k: Key) -> Terms:
    """``c·(sum)`` distributes where the product is a rational times one
    sum (the last step of ``Mul.flatten``)."""
    pows, imag, adds = k
    if not pows and not imag and len(adds) == 1:
        (base, e), = adds
        if e == 1:
            out: Terms = {}
            for bk, bc in base.terms.items():
                cc, kk = _mul_keys(c, _ONE_KEY, bc, bk)
                out[kk] = out.get(kk, Fraction(0)) + cc
            return out
    return {k: c}


def mul(a, b):
    """``a*b`` with sympy's automatic evaluation."""
    ta, tb = _terms(a), _terms(b)
    if not ta or not tb:
        return 0
    if set(tb) == {_ONE_KEY} and set(ta) != {_ONE_KEY}:
        ta, tb = tb, ta
    if set(ta) == {_ONE_KEY} and len(tb) > 1:
        # a rational times a sum distributes (``_keep_coeff``)
        return _number({k: ta[_ONE_KEY] * c for k, c in tb.items()})
    c, k = _mul_keys(*_as_factor(ta), *_as_factor(tb))
    return _number(_distributed(c, k))


def expand_mul(a, b):
    """``(a*b).expand()``: every term of a times every term of b."""
    out: Terms = {}
    for k1, c1 in _terms(a).items():
        for k2, c2 in _terms(b).items():
            c, k = _mul_keys(c1, k1, c2, k2)
            c, pows, imag = _settled((c, list(k[0]), k[1]))
            k = (tuple(pows), imag, k[2])
            for kk, cc in _distributed(c, k).items():
                out[kk] = out.get(kk, Fraction(0)) + cc
    return _number(out)


def add(a, b):
    out = _terms(a)
    for k, c in _terms(b).items():
        out[k] = out.get(k, Fraction(0)) + c
    return _number(out)


def power(x, e):
    """``x**e`` for a rational exponent e, as sympy evaluates it where x is
    a positive rational, a term, or a sum (kept as a power)."""
    e = Fraction(e)
    t = _terms(x)
    if not t:
        if e <= 0:
            raise ZeroDivisionError("0 to a non-positive power")
        return 0
    if e == 1:
        return _number(t)
    if set(t) == {_ONE_KEY}:
        r = t[_ONE_KEY]
        if e.denominator == 1:
            return _rat(r ** e.numerator)
        if r < 0:
            if e == Fraction(1, 2):
                c, pows, imag = _rat_pow(-r, e)
                return _number({(tuple(pows), not imag, frozenset()): c})
            raise NotImplementedError(
                f"radexpr: ({r})**({e}) is not one of sympy's shapes here")
        c, pows, imag = _rat_pow(r, e)
        return _number({(tuple(pows), imag, frozenset()): c})
    if len(t) == 1 and e.denominator == 1:
        # Mul._eval_power: every factor to the integer power
        (k, c), = t.items()
        pows, imag, adds = k
        seq: List[Any] = [Fraction(c) ** e.numerator]
        seq += [("pow", b, pe * e) for b, pe in pows]
        if imag:
            seq += [_I] * (e.numerator % 4)
        cc, pp, im = _mul_numeric(seq)
        adds2 = frozenset((b, pe * e) for b, pe in adds)
        return _number(_distributed(cc, (tuple(pp), im, adds2)))
    if len(t) > 1:
        if e == -1 and _pure_complex(t):
            raise NotImplementedError(
                "radexpr: 1/(a + b·i) with rational a, b is not one of "
                "sympy's shapes here")
        return _number({((), False, frozenset({(Radical(t), e)})): Fraction(1)})
    raise NotImplementedError(
        f"radexpr: a product to the power {e} is not one of sympy's "
        f"shapes here")


def _pure_complex(t: Terms) -> bool:
    return all(k == _ONE_KEY or k == ((), True, frozenset()) for k in t)


def root(x, n: int):
    """``sympy.root(x, n)``: ``x**(1/n)``."""
    return power(x, Fraction(1, n))


def sqrt(x):
    return power(x, Fraction(1, 2))


# ---------------------------------------------------------------------------
# Radical
# ---------------------------------------------------------------------------

class Radical:
    """An exact number in sympy's automatic-evaluation form (see the module
    docstring).  Immutable; hashable on its structure."""

    __slots__ = ("terms", "_hash", "minpoly")

    def __init__(self, terms: Terms):
        self.terms = {k: Fraction(c) for k, c in terms.items() if c != 0}
        self._hash = None
        #: the primitive integer polynomial (highest degree first) of which
        #: this number is a root, where ``radical_roots`` found it
        self.minpoly: Optional[Tuple[int, ...]] = None

    # -- structure ---------------------------------------------------------
    def __eq__(self, other) -> bool:
        if isinstance(other, Radical):
            return self.terms == other.terms
        if isinstance(other, numbers.Number):
            return False
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        if self._hash is None:
            self._hash = hash(frozenset(self.terms.items()))
        return self._hash

    # -- arithmetic: sums and expanded products (as sympy's EX domain
    # expands them); ``mul``/``power`` give sympy's unexpanded forms ------
    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __neg__(self):
        return mul(-1, self)

    def __mul__(self, other):
        return expand_mul(self, other)

    __rmul__ = __mul__

    # -- values ------------------------------------------------------------
    def value(self, digits: int = _PREC) -> Tuple[Decimal, Decimal]:
        """The principal value as (real, imaginary) Decimals to about
        ``digits`` significant digits."""
        with localcontext() as ctx:
            ctx.prec = digits + 10
            re_, im_ = _value_terms(self.terms)
            ctx.prec = digits
            return +re_, +im_

    def __complex__(self) -> complex:
        re_, im_ = self.value(30)
        return complex(float(re_), float(im_))

    @property
    def is_real(self) -> Optional[bool]:
        """sympy's ``is_real`` for these shapes: True where no term holds the
        imaginary unit, False for a real part beside one imaginary term,
        None (undecided) where a power of a complex sum appears."""
        if not _has_imag(self.terms):
            return True
        complex_adds = any(_has_imag(b.terms)
                           for k in self.terms for b, _ in k[2])
        imag_terms = [k for k in self.terms if _has_imag({k: 1})]
        if not complex_adds and len(imag_terms) == 1:
            return False
        return None

    # -- rendering ---------------------------------------------------------
    def cformat(self, arg_of: Optional[str] = None) -> str:
        return _latex(self.terms)

    def __repr__(self) -> str:
        return f"Radical({_latex(self.terms)})"


def _has_imag(terms: Terms) -> bool:
    for pows, imag, adds in terms:
        if imag or any(_has_imag(b.terms) for b, _ in adds):
            return True
    return False


I = _number({((), True, frozenset()): Fraction(1)})


# ---------------------------------------------------------------------------
# Numeric values (decimal, principal branches)
# ---------------------------------------------------------------------------

def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cinv(a):
    n = a[0] * a[0] + a[1] * a[1]
    return a[0] / n, -a[1] / n


def _cpow_int(a, k: int):
    out = (Decimal(1), Decimal(0))
    base = a if k >= 0 else _cinv(a)
    for _ in range(abs(k)):
        out = _cmul(out, base)
    return out


def _croot(a, q: int):
    """The principal q-th root of a complex Decimal pair, by Newton's
    method from the double-precision principal root."""
    z0 = complex(float(a[0]), float(a[1])) ** (1.0 / q) if (a[0] or a[1]) \
        else 0j
    if z0 == 0:
        return Decimal(0), Decimal(0)
    z = (Decimal(z0.real), Decimal(z0.imag))
    for _ in range(12):
        zq1 = _cpow_int(z, q - 1)
        num = _cmul(zq1, z)
        num = (num[0] - a[0], num[1] - a[1])
        den = _cmul(zq1, (Decimal(q), Decimal(0)))
        step = _cmul(num, _cinv(den))
        z = (z[0] - step[0], z[1] - step[1])
    return z


def _value_terms(terms: Terms):
    re_, im_ = Decimal(0), Decimal(0)
    for k, c in terms.items():
        v = _value_term(c, k)
        re_ += v[0]
        im_ += v[1]
    return re_, im_


def _value_term(c: Fraction, k: Key):
    pows, imag, adds = k
    v = (Decimal(c.numerator) / Decimal(c.denominator), Decimal(0))
    for b, e in pows:
        r = Decimal(b) ** (Decimal(e.numerator) / Decimal(e.denominator))
        v = (v[0] * r, v[1] * r)
    if imag:
        v = (-v[1], v[0])
    for base, e in adds:
        bv = _value_terms(base.terms)
        w = _croot(bv, e.denominator) if e.denominator != 1 else bv
        v = _cmul(v, _cpow_int(w, e.numerator))
    return v


def _term_complex(c: Fraction, k: Key) -> complex:
    with localcontext() as ctx:
        ctx.prec = 30
        v = _value_term(c, k)
    return complex(float(v[0]), float(v[1]))


# ---------------------------------------------------------------------------
# sympy's sort keys and LaTeX printer, for these shapes
# ---------------------------------------------------------------------------

def _num_key(r) -> tuple:
    return (_NUMBER, (0, ()), (), Fraction(r))


_ONE_SORT = _num_key(1)


def _factor_list(k: Key) -> List[tuple]:
    """A term's non-numeric factors as ('pow', b, e), ('I',) and
    ('add', Radical, e), numeric powers of one exponent merged as sympy
    keeps them (one base per exponent)."""
    pows, imag, adds = k
    out: List[tuple] = [("pow", b, e) for b, e in pows]
    if imag:
        out.append(("I",))
    out += [("add", base, e) for base, e in adds]
    return out


def _factor_sort_key(f: tuple) -> tuple:
    if f[0] == "pow":
        return (_NUMBER, (1, (str(f[1]),)), _num_key(f[2]), 1)
    if f[0] == "I":
        return (_ATOM_I, (1, ("I",)), _ONE_SORT, 1)
    base, e = f[1], f[2]
    return (_ADD, _add_args(base.terms), _num_key(e), 1)


def _add_args(terms: Terms) -> tuple:
    keys = tuple(_term_sort_key(c, k) for c, k in _ordered_terms(terms))
    return (len(keys), keys)


def _term_sort_key(c: Fraction, k: Key) -> tuple:
    """``Expr.sort_key`` of one term ``c·factors``."""
    if k == _ONE_KEY:
        return _num_key(c)
    factors = _factor_list(k)
    if len(factors) == 1:
        return _factor_sort_key(factors[0])[:3] + (_rat(c),)
    inner = tuple(sorted((_factor_sort_key(f) for f in factors)))
    return (_MUL, (len(inner), inner), _ONE_SORT, _rat(c))


def _ordered_terms(terms: Terms) -> List[Tuple[Fraction, Key]]:
    """``Expr.as_ordered_terms``: the special pair (positive number,
    negative number times one factor) as it is, else by the terms' complex
    values: real terms first, then by imaginary part, then real part."""
    items = [(c, k) for k, c in terms.items()]
    if len(items) == 2:
        nums = [it for it in items if it[1] == _ONE_KEY]
        others = [it for it in items if it[1] != _ONE_KEY]
        if len(nums) == 1 and len(others) == 1:
            (n, _), (c, k) = nums[0], others[0]
            if len(_factor_list(k)) == 1 and n > 0 and c < 0:
                return [nums[0], others[0]]

    def key(item):
        z = _term_complex(*item)
        return (bool(z.imag), z.imag, z.real, z.imag)

    return sorted(items, key=key)


def _term_nodes(c: Fraction, k: Key) -> int:
    """The number of sympy ``Basic`` nodes in one term."""
    if k == _ONE_KEY:
        return 1
    factors = _factor_list(k)
    n = sum(1 if f[0] == "I" else 3 if f[0] == "pow"
            else _nodes_of(f[1].terms) + (0 if f[2] == 1 else 2)
            for f in factors)
    if c == 1 and len(factors) == 1:
        return n
    return 1 + n + (0 if c == 1 else 1)


def _nodes_of(terms: Terms) -> int:
    if len(terms) == 1:
        (k, c), = terms.items()
        return _term_nodes(c, k)
    return 1 + sum(_term_nodes(c, k) for k, c in terms.items())


def ordered_key(x) -> tuple:
    """sympy's ``ordered`` key of a number: its node count, then its
    ``sort_key`` (``roots(..., multiple=True)`` lists roots so)."""
    t = _terms(x)
    if not t:
        return (1, _num_key(0))
    if len(t) == 1:
        (k, c), = t.items()
        return (_term_nodes(c, k), _term_sort_key(c, k))
    return (_nodes_of(t), (_ADD, _add_args(t), _ONE_SORT, 1))


def _latex_rational(r) -> str:
    r = Fraction(r)
    if r.denominator == 1:
        return str(r.numerator)
    if r < 0:
        return r"- \frac{%d}{%d}" % (-r.numerator, r.denominator)
    return r"\frac{%d}{%d}" % (r.numerator, r.denominator)


def _latex(terms: Terms) -> str:
    """``LatexPrinter._print_Add``."""
    ordered = _ordered_terms(terms)
    if len(ordered) == 1:
        return _latex_term(*ordered[0])
    tex = ""
    for i, (c, k) in enumerate(ordered):
        if i == 0:
            tex += _latex_term(c, k)
        elif c < 0:
            tex += " - " + _latex_term(-c, k)
        else:
            tex += " + " + _latex_term(c, k)
    return tex


def _latex_factor(f: tuple) -> str:
    """``_print_Pow`` / ``_print`` of one factor with a positive exponent."""
    if f[0] == "I":
        return "i"
    if f[0] == "pow":
        base, e = str(f[1]), f[2]
    else:
        base, e = _latex(f[1].terms), f[2]
        if e == 1:
            return base
    if abs(e.numerator) == 1 and e.denominator != 1:
        rt = (r"\sqrt{%s}" % base if e.denominator == 2
              else r"\sqrt[%d]{%s}" % (e.denominator, base))
        return rt if e > 0 else r"\frac{1}{%s}" % rt
    if f[0] == "add":
        base = r"\left(%s\right)" % base
    return r"%s^{%s}" % (base, _latex_rational(e) if e.denominator != 1
                         else str(e.numerator))


_NUM_END = re.compile(r"[0-9][} ]*$")
_NUM_START = re.compile(r"(\d|\\frac{\d+}{\d+})")


def _convert(coeff: int, factors: List[tuple]) -> str:
    """``_print_Mul``'s ``convert`` of ``coeff·factors``: a lone item as it
    prints alone, else the items in ``sort_key`` order, a sum in brackets,
    `` \\cdot `` between two numbers."""
    items: List[Tuple[tuple, str]] = []
    if coeff != 1:
        items.append((_num_key(coeff), str(coeff)))
    for f in factors:
        items.append((_factor_sort_key(f), _latex_factor(f)))
    if not items:
        return "1"
    if len(items) == 1:
        return items[0][1]
    for i, f in enumerate(factors):
        if f[0] == "add" and f[2] == 1:
            j = i + (coeff != 1)
            items[j] = (items[j][0], r"\left(%s\right)" % items[j][1])
    items.sort(key=lambda a: a[0])
    out, last = "", ""
    for _, tex in items:
        if out and _NUM_END.search(last) and _NUM_START.match(tex):
            out += r" \cdot "
        elif out:
            out += " "
        out += tex
        last = tex
    return out


def _latex_term(c: Fraction, k: Key) -> str:
    """``_print_Mul`` (or the printer of a lone factor) of ``c·factors``:
    a leading ``- ``, then ``fraction(exact=True)``'s numerator over its
    denominator."""
    c = Fraction(c)
    if k == _ONE_KEY:
        return _latex_rational(c)
    factors = _factor_list(k)
    if c == 1 and len(factors) == 1 and (factors[0][0] == "I"
                                         or factors[0][2] > 0):
        return _latex_factor(factors[0])
    tex = ""
    if c < 0:
        tex, c = "- ", -c
    num = [f for f in factors if f[0] == "I" or f[2] > 0]
    den = [(f[0], f[1], -f[2]) for f in factors if f[0] != "I" and f[2] < 0]
    if c.denominator == 1 and not den:
        return tex + _convert(c.numerator, num)
    return tex + r"\frac{%s}{%s}" % (_convert(c.numerator, num),
                                     _convert(c.denominator, den))
