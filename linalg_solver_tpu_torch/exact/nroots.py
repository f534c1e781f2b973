"""Roots of polynomials with float coefficients: the port's counterpart of
what ``sympy.roots`` returns on the domain RR (``Poly.nroots``: mpmath's
``polyroots`` at 15 digits), with no sympy and no mpmath.

``polyroots`` is Durand–Kerner on mpmath's ``mpc`` numbers at 53 + 10·deg
bits (15·deg on a second try when 50 steps do not reach 2⁻⁵²), its
``cleanup`` of tiny parts, then each root rounded to 53 bits.  Every
operation is mpmath's, rounded to nearest (ties to even) from the exact
result: ``_Mpf`` is a binary number ``man·2^exp`` and the complex product,
quotient and modulus are ``libmpc``'s, double roundings included, so the
roots agree with sympy's bit for bit.  A real root is a ``Float``, a
complex one a ``Complex``; both print as ``sympy.latex`` prints sympy's
``Float`` and ``Float + Float·I``.  The roots come sorted as ``nroots``
sorts them (real ones first, then by real part, |imaginary part| and its
sign), equal ones merged as ``roots``' ``_update_dict`` merges them.

``remove_float_root`` is the JAX package's ``Polynomial.remove_root`` on
such a root: ``sympy.div`` over RR or CC (synthetic division, each step
rounded to 53 bits), then its 40-digit test of the remainder.
"""

from __future__ import annotations

import math
import numbers
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from ..utils.fmt import _latex_float

_DPS_PREC = 53          # mpmath's prec at 15 digits
_MAXSTEPS = 50


# ---------------------------------------------------------------------------
# Binary floating point as mpmath's libmpf: man·2^exp, rounded to nearest
# ---------------------------------------------------------------------------

Mpf = Tuple[int, int]             # (signed mantissa, exponent); zero (0, 0)
ZERO: Mpf = (0, 0)
ONE: Mpf = (1, 0)


def _round(man: int, exp: int, prec: int, sticky: bool = False,
           down: bool = False) -> Mpf:
    """man·2^exp rounded to ``prec`` bits, to nearest with ties to even
    (``round_nearest``) or toward zero where ``down`` (``round_down``, which
    libmpc's intermediate sums take); ``sticky`` marks a nonzero tail below
    the last bit of ``man``."""
    if man == 0:
        return ZERO
    sign, m = (-1 if man < 0 else 1), abs(man)
    shift = m.bit_length() - prec
    if shift > 0:
        rest = m & ((1 << shift) - 1)
        m >>= shift
        exp += shift
        half = 1 << (shift - 1)
        if not down and (rest > half or (rest == half and (sticky or m & 1))):
            m += 1
    elif sticky:
        raise ValueError("a sticky tail needs bits to round away")
    while m and not m & 1:
        m >>= 1
        exp += 1
    return sign * m, exp


def add(a: Mpf, b: Mpf, prec: int, down: bool = False) -> Mpf:
    if a[0] == 0:
        return _round(b[0], b[1], prec, down=down)
    if b[0] == 0:
        return _round(a[0], a[1], prec, down=down)
    e = min(a[1], b[1])
    return _round((a[0] << (a[1] - e)) + (b[0] << (b[1] - e)), e, prec,
                  down=down)


def neg(a: Mpf) -> Mpf:
    return -a[0], a[1]


def sub(a: Mpf, b: Mpf, prec: int, down: bool = False) -> Mpf:
    return add(a, neg(b), prec, down)


def mul(a: Mpf, b: Mpf, prec: Optional[int] = None) -> Mpf:
    """The product, exact where ``prec`` is None."""
    if prec is None:
        return (a[0] * b[0], a[1] + b[1]) if a[0] and b[0] else ZERO
    return _round(a[0] * b[0], a[1] + b[1], prec)


def div(a: Mpf, b: Mpf, prec: int) -> Mpf:
    if b[0] == 0:
        raise ZeroDivisionError
    if a[0] == 0:
        return ZERO
    sign = -1 if (a[0] < 0) != (b[0] < 0) else 1
    am, bm = abs(a[0]), abs(b[0])
    extra = max(prec - am.bit_length() + bm.bit_length() + 5, 5)
    quot, rem = divmod(am << extra, bm)
    return _round(sign * quot, a[1] - b[1] - extra, prec, sticky=rem != 0)


def sqrt(a: Mpf, prec: int) -> Mpf:
    """The correctly rounded square root of a non-negative number."""
    if a[0] == 0:
        return ZERO
    m, e = a
    if e & 1:
        m, e = m << 1, e - 1
    shift = max(2 * prec + 4 - m.bit_length(), 0)
    shift += shift & 1
    m, e = m << shift, e - shift
    s = math.isqrt(m)
    return _round(s, e // 2, prec, sticky=s * s != m)


def less(a: Mpf, b: Mpf) -> bool:
    e = min(a[1], b[1])
    return (a[0] << (a[1] - e)) < (b[0] << (b[1] - e))


def from_float(x: float) -> Mpf:
    if x == 0:
        return ZERO
    m, e = math.frexp(x)
    return _round(int(m * (1 << 53)), e - 53, 53)


def to_float(a: Mpf) -> float:
    return math.ldexp(a[0], a[1])


# -- complex numbers as (re, im) pairs, libmpc's operations -----------------

Mpc = Tuple[Mpf, Mpf]


def c_add(z: Mpc, w: Mpc, prec: int) -> Mpc:
    return add(z[0], w[0], prec), add(z[1], w[1], prec)


def c_sub(z: Mpc, w: Mpc, prec: int) -> Mpc:
    return sub(z[0], w[0], prec), sub(z[1], w[1], prec)


def c_mul(z: Mpc, w: Mpc, prec: int) -> Mpc:
    (a, b), (c, d) = z, w
    return (sub(mul(a, c), mul(b, d), prec),
            add(mul(a, d), mul(b, c), prec))


def c_div(z: Mpc, w: Mpc, prec: int) -> Mpc:
    """``mpc_div``: the numerators and c² + d² truncated to prec + 10 bits,
    then each quotient rounded to nearest."""
    (a, b), (c, d) = z, w
    wp = prec + 10
    mag = add(mul(c, c), mul(d, d), wp, down=True)
    t = add(mul(a, c), mul(b, d), wp, down=True)
    u = sub(mul(b, c), mul(a, d), wp, down=True)
    return div(t, mag, prec), div(u, mag, prec)


def c_abs(z: Mpc, prec: int) -> Mpf:
    """``mpf_hypot``: x² + y² truncated to prec + 4 bits, then its root
    rounded to nearest."""
    a, b = z
    if b[0] == 0:
        return _round(abs(a[0]), a[1], prec)
    if a[0] == 0:
        return _round(abs(b[0]), b[1], prec)
    return sqrt(add(mul(a, a), mul(b, b), prec + 4, down=True), prec)


def _c_max_less(err: List[Mpf], tol: Mpf) -> bool:
    return all(less(e, tol) for e in err)


# ---------------------------------------------------------------------------
# mpmath.polyroots
# ---------------------------------------------------------------------------

class NoConvergence(ArithmeticError):
    """mpmath's ``NoConvergence``: Durand–Kerner did not settle in 50
    steps at either extra precision."""


def _durand_kerner(coeffs: List[Mpc], extraprec: int) -> List[Mpc]:
    """``polyroots(coeffs, maxsteps=50, cleanup=True, extraprec=...)`` at
    mp.prec 53: the roots, rounded to 53 bits, in mpmath's own order."""
    tol = (1, 1 - _DPS_PREC)
    wp = _DPS_PREC + extraprec
    deg = len(coeffs) - 1
    lead = coeffs[0]
    if lead != (ONE, ZERO):
        coeffs = [c_div(c, lead, wp) for c in coeffs]
    roots = []
    for n in range(deg):
        z = (0.4 + 0.9j) ** n
        roots.append((from_float(z.real), from_float(z.imag)))
    err = [ONE] * deg
    for _ in range(_MAXSTEPS):
        if _c_max_less(err, tol):
            break
        for i in range(deg):
            p = roots[i]
            x = coeffs[0]
            for c in coeffs[1:]:
                x = c_add(c, c_mul(p, x, wp), wp)
            for j in range(deg):
                if i != j:
                    try:
                        x = c_div(x, c_sub(p, roots[j], wp), wp)
                    except ZeroDivisionError:
                        continue
            roots[i] = c_sub(p, x, wp)
            err[i] = c_abs(x, wp)
    if not _c_max_less(err, tol):
        raise NoConvergence(f"Didn't converge in maxsteps={_MAXSTEPS} steps.")
    out = []
    for r in roots:
        if less(c_abs(r, wp), tol):
            r = (ZERO, ZERO)
        elif less((abs(r[1][0]), r[1][1]), tol):
            r = (r[0], ZERO)
        elif less((abs(r[0][0]), r[0][1]), tol):
            r = (ZERO, r[1])
        out.append((_round(*r[0], _DPS_PREC), _round(*r[1], _DPS_PREC)))
    return out


def _sympy_number(x: float):
    """A sympy ``Float`` result: an exact zero becomes the Integer 0."""
    return Float(x) if x != 0 else 0


class Float(float):
    """A sympy ``Float`` of 53 bits: equal to a float of the same value,
    never to an int or a Fraction (sympy ≥ 1.13), printed as
    ``sympy.latex`` prints it.  Arithmetic with ints, Fractions and floats
    rounds as sympy's does (the other operand rounded to 53 bits, then the
    result) and stays a ``Float``, but for an exact zero, which sympy makes
    the Integer 0."""

    __slots__ = ()
    is_real = True

    def __eq__(self, other):
        if isinstance(other, float):
            return float.__eq__(self, other)
        if isinstance(other, (numbers.Rational, Complex)):
            return False
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = float.__hash__

    def _binary(op):
        def method(self, other):
            if not isinstance(other, (float, numbers.Rational)):
                return NotImplemented
            return _sympy_number(op(float(self), float(other)))
        return method

    __add__ = _binary(lambda a, b: a + b)
    __radd__ = _binary(lambda a, b: b + a)
    __sub__ = _binary(lambda a, b: a - b)
    __rsub__ = _binary(lambda a, b: b - a)
    __mul__ = _binary(lambda a, b: a * b)
    __rmul__ = _binary(lambda a, b: b * a)
    __truediv__ = _binary(lambda a, b: a / b)
    __rtruediv__ = _binary(lambda a, b: b / a)
    del _binary

    def __neg__(self):
        return Float(-float(self))

    def __pos__(self):
        return self

    def __abs__(self):
        return Float(abs(float(self)))

    def cformat(self, arg_of: Optional[str] = None) -> str:
        return _latex_float(float(self))

    def __repr__(self) -> str:
        return f"Float({float(self)!r})"


class Complex:
    """``Float(re) + Float(im)·I`` (im ≠ 0; re may be 0, and then the
    number is ``Float(im)·I``), printed as ``sympy.latex`` prints it."""

    __slots__ = ("re", "im")
    is_real = False

    def __init__(self, re: float, im: float):
        self.re, self.im = float(re), float(im)

    def __eq__(self, other):
        if isinstance(other, Complex):
            return (self.re, self.im) == (other.re, other.im)
        return False

    def __hash__(self):
        return hash(("Complex", self.re, self.im))

    def __neg__(self):
        return Complex(-self.re, -self.im)

    def __complex__(self):
        return complex(self.re, self.im)

    def cformat(self, arg_of: Optional[str] = None) -> str:
        imag = _latex_float(abs(self.im)) + " i"
        if self.re == 0:
            return ("- " if self.im < 0 else "") + imag
        return _latex_float(self.re) + (" - " if self.im < 0 else " + ") + imag

    def __repr__(self) -> str:
        return f"Complex({self.re!r}, {self.im!r})"


def nroots(coeffs: List[float]) -> List:
    """``Poly.nroots(n=15)`` of the float polynomial ``coeffs`` (highest
    degree first, nonzero constant term): ``Float`` and ``Complex`` roots
    in nroots' order (real before complex, then by real part, |imaginary
    part| and its sign); a root that cleanup makes exactly 0 is the int 0,
    as sympy makes it ``S.Zero``."""
    cs = [(from_float(float(c)), ZERO) for c in coeffs]
    deg = len(cs) - 1
    if deg <= 0:
        return []
    try:
        raw = _durand_kerner(cs, 10 * deg)
    except NoConvergence:
        try:
            raw = _durand_kerner(cs, 15 * deg)
        except NoConvergence:
            raise NoConvergence(
                f"convergence to root failed; try n < 15 or maxsteps > "
                f"{_MAXSTEPS}") from None
    pairs = [(to_float(re_), to_float(im_)) for re_, im_ in raw]
    pairs.sort(key=lambda z: (1 if z[1] else 0, z[0], abs(z[1]),
                              (z[1] > 0) - (z[1] < 0)))
    out = []
    for re_, im_ in pairs:
        if im_:
            out.append(Complex(re_, im_))
        elif re_:
            out.append(Float(re_))
        else:
            out.append(0)
    return out


def is_real_float(coeffs) -> bool:
    """Whether sympy takes these coefficients over RR: each rational or a
    float (a ``Float``), and one a float at least."""
    coeffs = list(coeffs)
    return all(isinstance(c, (float, numbers.Rational)) for c in coeffs) \
        and any(isinstance(c, float) for c in coeffs)


def float_roots(powers: Dict[int, object]) -> Dict[object, int]:
    """``sympy.roots`` of ``Σ c_e·x^e`` on RR (a coefficient a float): the
    zero roots stripped and added back last, the rest ``nroots``, equal
    roots merged."""
    low = min(powers)
    deg = max(powers)
    result: Dict[object, int] = {}
    zeros = low
    for r in nroots([powers.get(e, 0) for e in range(deg, low - 1, -1)]):
        if isinstance(r, int):
            zeros += 1
        result[r] = result.get(r, 0) + 1
    if zeros:
        result[0] = zeros
    return result


# ---------------------------------------------------------------------------
# The JAX package's remove_root on RR / CC
# ---------------------------------------------------------------------------

def _as_mpc(x) -> Mpc:
    if isinstance(x, Complex):
        return from_float(x.re), from_float(x.im)
    return from_float(float(x)), ZERO


def _from_mpc(z: Mpc):
    re_, im_ = to_float(z[0]), to_float(z[1])
    return Complex(re_, im_) if im_ else Float(re_)


def remove_float_root(powers: Dict[int, object], root) -> Dict[int, object]:
    """``remove_root`` of the JAX package on a float polynomial: the
    quotient by (x − root) in ``sympy.div``'s RR / CC arithmetic (each
    product and difference rounded to 53 bits), as ``Float`` / ``Complex``
    coefficients; ``ValueError`` where the remainder is not zero, unless it
    is below 10⁻²⁰ of the largest coefficient (and of 1) in modulus."""
    deg = max(powers)
    g = _as_mpc(root)
    carry: Mpc = (ZERO, ZERO)
    quot: Dict[int, object] = {}
    for e in range(deg, -1, -1):
        c = _as_mpc(powers.get(e, 0))
        if e == deg:
            carry = c
        else:
            carry = c_add(c, c_mul(g, carry, _DPS_PREC), _DPS_PREC)
        if e:
            if carry != (ZERO, ZERO):
                quot[e - 1] = _from_mpc(carry)
    if carry != (ZERO, ZERO):
        ref = max([abs(complex(v)) for v in powers.values()] + [1.0])
        if abs(complex(*map(to_float, carry))) >= 1e-20 * ref:
            raise ValueError(
                f"{root} is not a root of the polynomial, division resulted "
                f"in remainder {complex(*map(to_float, carry))}")
    return quot


# ---------------------------------------------------------------------------
# The JAX package's AddRow quotient (sympy.cancel) on RR
# ---------------------------------------------------------------------------

_MAX_DENOM = 2 ** _DPS_PREC // 200      # RealField's max_denom for to_rational


def _to_rational(c) -> Fraction:
    """``QQ.convert`` of an RR element: a float as ``RealField.to_rational``
    makes it (its binary value, or the nearest fraction with a denominator
    up to ``_MAX_DENOM``)."""
    if isinstance(c, numbers.Rational):
        return Fraction(c)
    return Fraction(float(c)).limit_denominator(_MAX_DENOM)


def cancel_quotient(num: Dict[int, object], den: Dict[int, object]
                    ) -> Optional[Dict[int, object]]:
    """``expand(cancel(num/den))`` of two polynomials of which one has a
    float coefficient, where den divides num: sympy's ``cancel`` on RR
    takes the gcd over QQ (``dup_inner_gcd``), so P = num·lc(den)/den
    rounded to 53 bits over Q = lc(den) (both negated where lc(den) < 0),
    and ``expand`` multiplies each coefficient of P by the 53-bit 1/Q.  The
    coefficients are ``Float``; None where den does not divide num."""
    n = {e: _to_rational(c) for e, c in num.items()}
    d = {e: _to_rational(c) for e, c in den.items()}
    dd = max(d)
    lead = d[dd]
    quot: Dict[int, Fraction] = {}
    while n and max(n) >= dd:
        top = max(n)
        c = n[top] / lead
        quot[top - dd] = c
        for e, x in d.items():
            k = e + top - dd
            n[k] = n.get(k, 0) - c * x
            if n[k] == 0:
                del n[k]
    if n:
        return None
    sign = -1 if lead < 0 else 1
    inv = 1.0 / float(sign * lead)
    out = {}
    for e, c in quot.items():
        v = _sympy_number(float(sign * c * lead) * inv)
        if v != 0:
            out[e] = v
    return out
