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

import functools
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
        if e < 0:
            raise NotImplementedError(
                f"radexpr: ({b})**({e}) is not one of sympy's shapes here")
        # a perfect root, or the roots collected from -b, times (-1)**e
        x, exact = _nthroot(-b, e.denominator)
        got = (Fraction(x ** e.numerator), [], False) if exact \
            else _int_pow(-b, e)
        if got is None:
            return None
        return _times(got, (Fraction(1), [(-1, e)], False))
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
    """``Rational(r)**e`` (r > 0, or r < 0 and e > 0), as
    ``Rational._eval_power``."""
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
            else:
                if b < 0:
                    neg1e += e
                    b = -b
                if b != 1:
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
    keep: List[Tuple[int, Fraction]] = []
    if neg1e:
        n, p = divmod(neg1e.numerator, neg1e.denominator)
        if n % 2:
            coeff = -coeff
        if neg1e.denominator == 2:
            imag = True
        elif p:
            # (-1)**(p/q) joins a positive base of the same exponent
            neg1e = Fraction(p, neg1e.denominator)
            if neg1e in pnew:
                pnew[neg1e] = [-math.prod(pnew[neg1e])]
            else:
                keep.append((-1, neg1e))
    out: List[Tuple[int, Fraction]] = list(keep)
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
        if e == 1 and isinstance(base, Radical):
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


def expand(x):
    """``x.expand()``: every product of a term and a sum (a power of a sum
    to the exponent 1) distributed, sums inside expanded first."""
    out: Terms = {}
    for k, c in _terms(x).items():
        pows, imag, adds = k
        sums = [b for b, e in adds if isinstance(b, Radical) and e == 1]
        if not sums:
            part = {k: c}
        else:
            rest = (pows, imag, frozenset((b, e) for b, e in adds
                                          if not (b in sums and e == 1)))
            acc = _number({rest: c})
            for b in sums:
                acc = expand_mul(acc, expand(_number(b.terms)))
            part = _terms(acc)
        for kk, cc in part.items():
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
            if e < 0:
                raise NotImplementedError(
                    f"radexpr: ({r})**({e}) is not one of sympy's shapes "
                    f"here")
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
# count_ops (the measure sympy's simplify minimises)
# ---------------------------------------------------------------------------

def count_ops(x) -> int:
    """``sympy.count_ops(x)`` for these numbers: NEG and DIV of a rational,
    a Mul's NEG, its DIV where it is a fraction and MUL between its
    factors, ADD / SUB between an Add's terms (NEG where all are
    negative), POW and the exponent of a power (DIV alone for 1/b)."""
    t = _terms(x)
    if not t:
        return 0
    if len(t) == 1:
        (k, c), = t.items()
        return _count_term(c, k)
    ops, negs = 0, 0
    items = sorted(t.items(), key=lambda kc: functools.cmp_to_key(_compare)(
        _term_node(kc[1], kc[0])))
    for i, (k, c) in enumerate(items):
        if c < 0:
            negs += 1
        ops += _count_term(abs(c), k) + (1 if i > 0 else 0)
    if negs == len(items):
        ops += 1
    return ops


def _count_num(r: Fraction) -> int:
    return 0 if r == 1 else (r < 0) + (r.denominator != 1)


def _count_factor(f: tuple) -> int:
    if f[0] == "I":
        return 0
    e = f[2]
    base = 0 if f[0] in ("pow", "trig") else count_ops(_number(f[1].terms))
    if e == -1:
        return 1 + base
    return 1 + base + _count_num(Fraction(e))


def _count_term(c: Fraction, k: Key) -> int:
    c = Fraction(c)
    if k == _ONE_KEY:
        return _count_num(c)
    factors = _factor_list(k)
    if c == 1 and len(factors) == 1:
        return _count_factor(factors[0])
    ops = 0
    if c < 0:
        ops, c = 1, -c
    num = [f for f in factors if f[0] == "I" or f[2] > 0]
    den = [(f[0], f[1], -f[2]) for f in factors if f[0] != "I" and f[2] < 0]
    n_int, d_int = c.numerator, c.denominator
    if not num:                                 # an integer over the rest
        d_items = ([] if d_int == 1 else [d_int]) + den
        return ops + 1 + _count_product(d_int, den, len(d_items))
    if den or d_int != 1:
        d_items = ([] if d_int == 1 else [d_int]) + den
        n_items = ([] if n_int == 1 else [n_int]) + num
        if den:
            ops += _count_product(d_int, den, len(d_items))
        return ops + 1 + _count_product(n_int, num, len(n_items))
    return ops + _count_product(n_int, num, len(num) + (n_int != 1))


def _count_product(coeff: int, factors: List[tuple], nargs: int) -> int:
    """A Mul of a positive integer and factors: MUL between its arguments
    and each argument's own count."""
    if nargs == 1 and not factors:
        return _count_num(Fraction(coeff))
    if nargs == 1:
        return _count_factor(factors[0])
    return (nargs - 1) + _count_num(Fraction(coeff)) * (coeff != 1) + \
        sum(_count_factor(f) for f in factors)


# ---------------------------------------------------------------------------
# cos and sin of rational multiples of π (sympy's cos.eval / sin.eval)
# ---------------------------------------------------------------------------

_PI = Decimal("3.14159265358979323846264338327950288419716939937510582097494"
              "459230781640628620899862803482534211706798")
# cos(kπ/q) = cos(kπ/a)·cos(kπ/b) + sin(kπ/a)·sin(kπ/b) (sympy's _table2)
_TABLE2 = {12: (3, 4), 20: (4, 5), 30: (5, 6), 15: (6, 10), 24: (6, 8),
           40: (8, 10), 60: (20, 30), 120: (40, 60)}


class Trig:
    """The unevaluated ``cos(r·π)`` or ``sin(r·π)`` that sympy keeps for
    0 < r < 1/2 where it has no radicals (a denominator of r above 12 and
    not in its table, or 7, 9, 11): a factor of a term, like a power of a
    sum."""

    __slots__ = ("name", "r")

    def __init__(self, name: str, r: Fraction):
        self.name, self.r = name, Fraction(r)

    def __eq__(self, other) -> bool:
        return isinstance(other, Trig) and (self.name, self.r) == \
            (other.name, other.r)

    def __hash__(self) -> int:
        return hash(("Trig", self.name, self.r))

    @property
    def class_key(self) -> tuple:
        """``Function.class_key``: (4, 20, 'sin') or (4, 21, 'cos')."""
        return (4, 20 if self.name == "sin" else 21, self.name)

    def value(self) -> Decimal:
        """cos or sin of r·π by its Taylor series at the context's
        precision."""
        with localcontext() as ctx:
            ctx.prec += 10
            x = _PI * Decimal(self.r.numerator) / Decimal(self.r.denominator)
            term = Decimal(1) if self.name == "cos" else x
            total, k = term, 1 if self.name == "cos" else 2
            while True:
                term = -term * x * x / (Decimal(k) * Decimal(k + 1))
                k += 2
                if abs(term) < Decimal(10) ** -(ctx.prec + 2):
                    break
                total += term
        return +total

    def latex_arg(self) -> str:
        p, q = self.r.numerator, self.r.denominator
        top = r"\pi" if p == 1 else r"%d \pi" % p
        return r"\frac{%s}{%d}" % (top, q)

    def __repr__(self) -> str:
        return f"{self.name}({self.r}*pi)"


def _trig_number(name: str, r: Fraction):
    return _number({((), False, frozenset({(Trig(name, r), Fraction(1))})):
                    Fraction(1)})


def _is_atom(x, name: str) -> bool:
    t = _terms(x)
    if len(t) != 1:
        return False
    (k, c), = t.items()
    if c != 1 or k[0] or k[1] or len(k[2]) != 1:
        return False
    (base, e), = k[2]
    return isinstance(base, Trig) and base.name == name and e == 1


def _chebyshev_t(p: int, x):
    """T_p(x), expanded."""
    t0, t1 = 1, x
    if p == 0:
        return t0
    for _ in range(p - 1):
        t0, t1 = t1, add(expand_mul(2, expand_mul(x, t1)), mul(-1, t0))
    return t1


def cos_pi(r):
    """``cos(r·π)`` as sympy evaluates it: radicals for a denominator of
    r up to 12 but 7, 9 and 11 (3 and 5 by Chebyshev polynomials, even ones
    by the half angle) and those of its table, else the atom."""
    r = Fraction(r)
    if r < 0:
        r = -r
    if r.denominator == 1:
        return (-1) ** (r.numerator % 2)
    if r.denominator == 2:
        return 0
    q = r.denominator
    p = r.numerator % (2 * q)
    if p > q:
        return mul(-1, cos_pi(r - 1))
    if 2 * p > q:
        return mul(-1, cos_pi(1 - r))
    if q in _TABLE2:
        a, b = _TABLE2[q]
        a, b = Fraction(p, a), Fraction(p, b)
        return add(mul(cos_pi(a), cos_pi(b)),
                   mul(cos_pi(Fraction(1, 2) - a), cos_pi(Fraction(1, 2) - b)))
    if q > 12:
        return _trig_number("cos", r)
    if q == 3:
        return _chebyshev_t(r.numerator, Fraction(1, 2))
    if q == 5:
        return _chebyshev_t(r.numerator,
                            add(Fraction(1, 4), mul(sqrt(5), Fraction(1, 4))))
    if q % 2 == 0:
        nval = cos_pi(2 * r)
        x = (2 * r + 1) / 2
        sign = (-1) ** (int(abs(x)) % 2)
        return mul(sign, sqrt(mul(add(1, nval), Fraction(1, 2))))
    return _trig_number("cos", r)


def sin_pi(r):
    """``sin(r·π)`` as sympy evaluates it: through cos((r + 3/2)·π), else
    the atom."""
    r = Fraction(r)
    if r < 0:
        return mul(-1, sin_pi(-r))
    if r.denominator == 1:
        return 0
    if r.denominator == 2:
        return (-1) ** (((r - Fraction(1, 2)).numerator) % 2)
    x = r % 2
    if x > 1:
        return mul(-1, sin_pi(x % 1))
    if 2 * x > 1:
        return sin_pi(1 - x)
    got = cos_pi((r + Fraction(3, 2)) % 2)
    if _is_atom(got, "cos"):
        return _trig_number("sin", r)
    return got


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
        """sympy's ``is_real`` of the same expression (``_assume``)."""
        return _add_facts(self.terms).real

    # -- rendering ---------------------------------------------------------
    def cformat(self, arg_of: Optional[str] = None) -> str:
        return _latex(self.terms)

    def __repr__(self) -> str:
        return f"Radical({_latex(self.terms)})"


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


def numeric(x, digits: int = _PREC) -> Tuple[Decimal, Decimal]:
    """The value of a root of any kind the port writes (a rational, a
    float or ``nroots``' ``Float`` and ``Complex``, a ``Surd``, a
    ``Radical``) as (real, imaginary) Decimals to about ``digits``
    significant digits."""
    if isinstance(x, numbers.Rational):
        with localcontext() as ctx:
            ctx.prec = digits
            return Decimal(x.numerator) / x.denominator, Decimal(0)
    if isinstance(x, float):
        return Decimal(x), Decimal(0)
    if hasattr(x, "value"):
        return x.value(digits)
    z = complex(x)
    return Decimal(z.real), Decimal(z.imag)


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
        if b < 0:                   # the principal root of a negative base
            w = _cpow_int(_croot((Decimal(b), Decimal(0)), e.denominator),
                          e.numerator)
            v = _cmul(v, w)
            continue
        r = Decimal(b) ** (Decimal(e.numerator) / Decimal(e.denominator))
        v = (v[0] * r, v[1] * r)
    if imag:
        v = (-v[1], v[0])
    for base, e in adds:
        if isinstance(base, Trig):
            v = _cmul(v, _cpow_int((base.value(), Decimal(0)), e.numerator))
            continue
        bv = _value_terms(base.terms)
        w = _croot(bv, e.denominator) if e.denominator != 1 else bv
        v = _cmul(v, _cpow_int(w, e.numerator))
    return v


def _term_complex(c: Fraction, k: Key) -> complex:
    """A term's value as ``Expr.as_terms`` computes it to order an Add: the
    coefficient as a complex double times each factor's value rounded to
    a double, in the order of the Mul's arguments."""
    v = complex(float(Fraction(c)))
    node = _term_node(Fraction(1), k) if k != _ONE_KEY else None
    if node is None:
        return v
    for f in (node[1] if node[0] == "mul" else [node]):
        v *= _node_complex(f)
    return v


def _node_complex(n: tuple) -> complex:
    with localcontext() as ctx:
        ctx.prec = 40
        if n[0] == "I":
            return 1j
        if n[0] == "fn":
            return complex(float(n[1].value()), 0.0)
        if n[0] == "pow" and n[1][0] == "fn":
            return complex(float(n[1][1].value() ** int(n[2])), 0.0)
        if n[0] == "pow" and n[1][0] == "num":
            key: Key = (((int(n[1][1]), n[2]),), False, frozenset())
        else:
            key = ((), False, frozenset({(n[1][1], n[2])}))
        v = _value_term(Fraction(1), key)
    return complex(float(v[0]), float(v[1]))


# ---------------------------------------------------------------------------
# sympy's assumptions on these numbers (is_real and what it rests on)
# ---------------------------------------------------------------------------

class _Facts:
    """The facts sympy derives for a number: real, imaginary, positive,
    negative, zero (each True, False or None)."""

    __slots__ = ("real", "imag", "pos", "neg", "zero")

    def __init__(self, real, imag, pos, neg, zero):
        # the assumption system's deductions from the facts a handler gave
        if pos or neg:
            real, zero = True, False
            imag = False
        if imag:
            real, zero, pos, neg = False, False, False, False
        if real is False:
            pos, neg = False, False
        self.real, self.imag, self.pos, self.neg, self.zero = \
            real, imag, pos, neg, zero


_RATIONAL_FACTS = {1: _Facts(True, False, True, False, False),
                   -1: _Facts(True, False, False, True, False)}
_I_FACTS = _Facts(False, True, False, False, False)
_COMPLEX_FACTS = _Facts(False, False, False, False, False)


def _fuzzy_group(values, quick_exit=False):
    saw_other = False
    for a in values:
        if a is True:
            continue
        if a is None:
            return None
        if quick_exit and saw_other:
            return None
        saw_other = True
    return not saw_other


def _factor_facts(f: tuple) -> _Facts:
    if f[0] == "I":
        return _I_FACTS
    if f[0] == "pow":
        # a negative base's principal root is neither real nor imaginary
        return _RATIONAL_FACTS[1] if f[1] > 0 else _COMPLEX_FACTS
    if f[0] == "trig":                  # cos, sin of an angle in (0, π/2)
        return _RATIONAL_FACTS[1]
    base, e = f[1], f[2]
    b = _add_facts(base.terms)
    if b.real is None:
        real = None
    elif b.real:
        real = True if b.pos else (False if b.neg else None)
    elif e.numerator == 1:
        real = False
    elif e < 0 and b.zero is False:
        real = _factor_facts(("add", base, -e)).real
    else:
        real = None
    # Pow._eval_is_imaginary for a real base and a rational exponent
    imag = None
    if b.real:
        if b.pos:
            imag = False
        else:
            imag = b.neg if (2 * e).denominator == 1 else False
    pos = True if b.pos else None
    neg = False if b.pos else None
    zero = False if (b.zero is False or b.pos or b.neg) else None
    return _Facts(real, imag, pos, neg, zero)


def _term_facts(c: Fraction, k: Key) -> _Facts:
    """``Mul._eval_real_imag`` (is_real), ``_eval_pos_neg`` and
    ``_eval_is_zero`` of ``c·factors``."""
    factors = _factor_list(k)
    if k == _ONE_KEY:
        return _RATIONAL_FACTS[1 if c > 0 else -1]
    if c == 1 and len(factors) == 1:
        return _factor_facts(factors[0])
    fs = [_RATIONAL_FACTS[1 if c > 0 else -1]] + \
        [_factor_facts(f) for f in factors]
    # _eval_real_imag(real=True)
    real, zero, t_not, out = True, False, None, "open"
    for t in fs:
        if t.imag:
            real = not real
        elif t.real:
            z = t.zero
            if not z and zero is False:
                zero = z
            elif z:
                out = True
                break
        elif t.real is False or t.imag is False:
            if t_not is not None:
                out = None
                break
            t_not = t
        else:
            out = None
            break
    if out == "open":
        out = None
        if t_not is not None:
            if t_not.real is False and real:
                out = zero
            elif t_not.imag is False and not real:
                out = zero
        elif zero is False:
            out = real
        elif real:
            out = real
    # _eval_pos_neg: the sign where every factor's sign is known
    sign, pos, neg = 1, None, None
    for t in fs:
        if t.pos:
            continue
        if t.neg:
            sign = -sign
            continue
        sign = 0
        break
    if sign:
        pos, neg = sign > 0, sign < 0
    zero = False if all(t.zero is False for t in fs) else None
    return _Facts(out, None, pos, neg, zero)


_FACTS_CACHE: Dict[frozenset, _Facts] = {}


def _add_facts(terms: Terms) -> _Facts:
    """The facts of a sum: ``Add._eval_is_extended_real`` (every term real,
    or one not), and the sign sympy reads numerically
    (``Expr._eval_is_extended_positive_negative``: decided only where the
    sum evaluated term by term at 2 bits, ``_eval_evalf(2)``, is a finite
    real number; then the sign of its value)."""
    key = frozenset(terms.items())
    got = _FACTS_CACHE.get(key)
    if got is not None:
        return got
    if len(terms) == 1:
        (k, c), = terms.items()
        got = _term_facts(c, k)
    elif not terms:
        got = _Facts(True, False, False, False, True)
    else:
        real = _fuzzy_group((_term_facts(c, k).real
                             for k, c in terms.items()), quick_exit=True)
        pos = neg = None
        if _crude_add(terms)[0] == "r":
            with localcontext() as ctx:
                ctx.prec = 50
                re_, im_ = _value_terms(terms)
            if abs(im_) > Decimal(10) ** -40 * (1 + abs(re_)):
                pos = neg = False
            elif not _complex_inside(terms):
                # a real sum evaluated through complex numbers keeps an
                # imaginary part of no significance: evalf(2) decides no
                # sign
                pos, neg = re_ > 0, re_ < 0
        zero = False if (pos or neg) else None
        got = _Facts(real, None, pos, neg, zero)
    _FACTS_CACHE[key] = got
    return got


def _complex_inside(terms: Terms) -> bool:
    """Whether evaluating the sum passes through a complex number: the
    imaginary unit, a root of a negative integer, or a power of a sum with
    a complex value or one evaluated so itself."""
    for pows, imag, adds in terms:
        if imag or any(b < 0 for b, _ in pows):
            return True
        for base, _ in adds:
            if isinstance(base, Trig):
                continue
            with localcontext() as ctx:
                ctx.prec = 50
                re_, im_ = _value_terms(base.terms)
            if abs(im_) > Decimal(10) ** -40 * (1 + abs(re_)) \
                    or _complex_inside(base.terms):
                return True
    return False


# -- _eval_evalf(2): every node evaluated at 2 bits, numbers folded in
# argument order, each step rounded to nearest -------------------------------

_P2 = 2


def _f2(x: Fraction):
    from .nroots import div
    x = Fraction(x)
    if x == 0:
        return ("r", (0, 0))
    return ("r", div((x.numerator, 0), (x.denominator, 0), _P2))


def _crude_mul(a, b):
    from .nroots import mul as fmul
    if a[0] == "r" and b[0] == "r":
        return ("r", fmul(a[1], b[1], _P2))
    kinds = {a[0], b[0]}
    if "nan" in kinds:
        return ("nan",)
    if "zoo" in kinds:
        zero = (a[0] == "r" and a[1][0] == 0) or (b[0] == "r" and b[1][0] == 0)
        return ("nan",) if zero else ("zoo",)
    return ("c",)


def _crude_add2(a, b):
    from .nroots import add as fadd
    if a[0] == "r" and b[0] == "r":
        return ("r", fadd(a[1], b[1], _P2))
    kinds = {a[0], b[0]}
    if "nan" in kinds or kinds == {"zoo"}:
        return ("nan",)
    if "zoo" in kinds:
        return ("zoo",)
    return ("c",)


def _crude_pow(base, e: Fraction):
    """``Pow(Float, Float(e))`` at 2 bits: mpf_pow of a positive base (a
    square root for e = ±1/2, else exp(e·log b) with the log at 12 bits),
    0 or zoo at a zero base, a complex number at a negative one."""
    from .nroots import _round, div, sqrt as fsqrt
    if base[0] == "zoo":
        return ("r", (0, 0)) if e < 0 else ("zoo",)
    if base[0] != "r":
        return base if base[0] == "nan" else ("c",)
    m, x = base[1]
    if m == 0:
        return ("zoo",) if e < 0 else ("r", (0, 0))
    if m < 0:
        return ("c",)
    ef = _f2(e)[1]                          # the exponent as a 2-bit Float
    if ef[1] == -1 and abs(ef[0]) == 1:      # ±1/2
        if ef[0] > 0:
            return ("r", fsqrt(base[1], _P2))
        return ("r", div((1, 0), fsqrt(base[1], _P2 + 10), _P2))
    with localcontext() as ctx:
        ctx.prec = 40
        lg = Fraction((Decimal(m) * Decimal(2) ** x).ln())
        # the log rounded to 12 bits, as mpf_log(s, prec + 10)
        lm = _round((lg.numerator << 200) // lg.denominator, -200, 12)
        v = (Decimal(lm[0]) * Decimal(2) ** lm[1] * Decimal(ef[0])
             * Decimal(2) ** ef[1]).exp()
        mant = int((v * Decimal(2) ** 60).to_integral_value())
    return ("r", _round(mant, -60, _P2))


# -- Basic.compare: the canonical order of Add and Mul arguments ------------

_CLASS_ORDER = ["Zero", "One", "Half", "NegativeOne", "Integer", "Rational",
                "ImaginaryUnit", "Pow", "Mul", "Add"]


def _num_class(r: Fraction) -> str:
    if r == 0:
        return "Zero"
    if r == 1:
        return "One"
    if r == -1:
        return "NegativeOne"
    if r == Fraction(1, 2):
        return "Half"
    return "Integer" if r.denominator == 1 else "Rational"


def _term_node(c: Fraction, k: Key) -> tuple:
    """One term as sympy's tree: ("num", r), ("I",), ("pow", base, e) with
    base ("num", b) or ("add", Radical), ("mul", args)."""
    c = Fraction(c)
    if k == _ONE_KEY:
        return ("num", c)
    factors = []
    for f in _factor_list(k):
        if f[0] == "I":
            factors.append(("I",))
        elif f[0] == "pow":
            factors.append(("pow", ("num", Fraction(f[1])), f[2]))
        elif f[0] == "trig":
            factors.append(("fn", f[1]) if f[2] == 1
                           else ("pow", ("fn", f[1]), f[2]))
        else:
            factors.append(("pow", ("add", f[1]), f[2]))
    if c == 1 and len(factors) == 1:
        return factors[0]
    factors.sort(key=functools.cmp_to_key(_compare))
    return ("mul", ([("num", c)] if c != 1 else []) + factors)


def _args_of(terms: Terms) -> List[tuple]:
    """An Add's arguments in sympy's order (``_addsort``)."""
    return sorted((_term_node(c, k) for k, c in terms.items()),
                  key=functools.cmp_to_key(_compare))


def _node_class(n: tuple) -> str:
    if n[0] == "num":
        return _num_class(n[1])
    if n[0] == "fn":
        return n[1].name
    return {"I": "ImaginaryUnit", "pow": "Pow", "mul": "Mul",
            "add": "Add"}[n[0]]


def _content(n: tuple) -> tuple:
    if n[0] == "num":
        r = n[1]
        return (r.numerator,) if r.denominator == 1 else \
            (r.numerator, r.denominator)
    if n[0] == "I":
        return ()
    if n[0] == "fn":
        return (n[1].r,)
    if n[0] == "pow":
        return (n[1], ("num", n[2]))
    if n[0] == "mul":
        return tuple(n[1])
    return tuple(_args_of(n[1].terms))


def _compare(a: tuple, b: tuple) -> int:
    """``Basic.compare``: the class order, then the length of the hashable
    content, then its items one by one."""
    ca, cb = _node_class(a), _node_class(b)
    if ca != cb:
        unknown = len(_CLASS_ORDER) + 1
        ia = _CLASS_ORDER.index(ca) if ca in _CLASS_ORDER else unknown
        ib = _CLASS_ORDER.index(cb) if cb in _CLASS_ORDER else unknown
        if ia == ib:
            return (ca > cb) - (ca < cb)
        return (ia > ib) - (ia < ib)
    sa, sb = _content(a), _content(b)
    if len(sa) != len(sb):
        return (len(sa) > len(sb)) - (len(sa) < len(sb))
    for x, y in zip(sa, sb):
        if isinstance(x, tuple):
            c = _compare(x, y)
        else:
            c = (x > y) - (x < y)
        if c:
            return c
    return 0


def _crude_node(n: tuple):
    """``_eval_evalf(2)`` of a node: ("r", mpf), ("c",) complex, ("zoo",) or
    ("nan",)."""
    if n[0] == "num":
        return _f2(n[1])
    if n[0] == "I":
        return ("c",)
    if n[0] == "fn":
        from .nroots import _round
        v = n[1].value()
        return ("r", _round(int(v * Decimal(2) ** 80), -80, _P2))
    if n[0] == "pow" and n[1][0] == "fn":
        return _crude_mul(("r", (1, 0)), _crude_node(n[1])) if n[2] == 1 \
            else _crude_pow(_crude_node(n[1]), n[2])
    if n[0] == "pow":
        return _crude_pow(_crude_node(n[1]), n[2])
    if n[0] == "mul":
        acc = ("r", (1, 0))
        for a in n[1]:
            acc = _crude_mul(acc, _crude_node(a))
        return acc
    return _crude_add(n[1].terms)


def _crude_add(terms: Terms):
    acc = None
    for a in _args_of(terms):
        t = _crude_node(a)
        acc = t if acc is None else _crude_add2(acc, t)
    return acc if acc is not None else ("r", (0, 0))


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
    out += [("trig" if isinstance(base, Trig) else "add", base, e)
            for base, e in adds]
    return out


def _factor_sort_key(f: tuple) -> tuple:
    if f[0] == "pow":
        return (_NUMBER, (1, (str(f[1]),)), _num_key(f[2]), 1)
    if f[0] == "I":
        return (_ATOM_I, (1, ("I",)), _ONE_SORT, 1)
    base, e = f[1], f[2]
    if f[0] == "trig":
        return (base.class_key, (1, ((("pi",), base.r),)), _num_key(e), 1)
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
            else (4 if f[0] == "trig" else _nodes_of(f[1].terms))
            + (0 if f[2] == 1 else 2)
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
    if f[0] == "trig":
        power = "" if f[2] == 1 else "^{%d}" % f[2]
        return r"\%s%s{\left(%s \right)}" % (f[1].name, power,
                                              f[1].latex_arg())
    if f[0] == "pow":
        base, e = str(f[1]), f[2]
        if f[1] < 0 and not (abs(e.numerator) == 1 and e.denominator != 1):
            base = r"\left(%s\right)" % base
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
