"""Hold the port's roots in radicals against sympy's ``roots`` on every
cubic a·x³ + b·x² + c·x + d with 1 ≤ a ≤ K, |b|, |c|, |d| ≤ K, d ≠ 0, where
K = ``BOUND`` = 4 (2,592 cubics, reducible ones included), and on every
binomial a·xⁿ − b at n = 3, 4, 6 with 1 ≤ a ≤ 3, 0 < |b| ≤ 30 (n = 8:
0 < b ≤ 30): the dict's order and multiplicities, the LaTeX of each root
and of its negation, ``is_real`` True where sympy's is, and (every 7th
cubic, every binomial) the value within 1e-25 of sympy's ``N(·, 40)``.  A
development check on the CPU; it needs sympy, which the port does not.

    PYTHONPATH=. python3 tools/sweep_radicals.py

Prints the counts checked and the mismatches, and exits 1 on any.
"""

import itertools
import sys
import time
from decimal import Decimal
from fractions import Fraction

import sympy

from linalg_solver_tpu_torch.exact import radicals
from linalg_solver_tpu_torch.utils.fmt import cformat

X = sympy.symbols("x")
BOUND = 4


def _value(r):
    if isinstance(r, (int, Fraction)):
        r = Fraction(r)
        return Decimal(r.numerator) / r.denominator, Decimal(0)
    return r.value(45)


def check(coeffs, values):
    """None where the port equals sympy on ``coeffs``, else a message."""
    deg = len(coeffs) - 1
    port = radicals.radical_roots({deg - i: c for i, c in enumerate(coeffs)
                                   if c})
    want = sympy.roots(sympy.Poly(coeffs, X), multiple=False)
    if len(port) != len(want):
        return f"{coeffs}: {len(port)} roots against sympy's {len(want)}"
    for (rp, mp), (rs, ms) in zip(port.items(), want.items()):
        if (mp, cformat(rp), cformat(-rp)) != (ms, sympy.latex(rs),
                                               sympy.latex(-rs)):
            return f"{coeffs}: {cformat(rp)} against {sympy.latex(rs)}"
        if (getattr(rp, "is_real", True) is True) != (rs.is_real is True):
            return f"{coeffs}: is_real differs on {cformat(rp)}"
        if values:
            w = sympy.N(rs, 40)
            w_re, w_im = Decimal(str(sympy.re(w))), Decimal(str(sympy.im(w)))
            re_, im_ = _value(rp)
            if abs(re_ - w_re) + abs(im_ - w_im) > Decimal("1e-25") * (
                    1 + abs(w_re) + abs(w_im)):
                return f"{coeffs}: the value of {cformat(rp)} differs"
    return None


def main():
    t0 = time.perf_counter()
    bad, count = [], 0
    for c in itertools.product(range(1, BOUND + 1),
                               *[range(-BOUND, BOUND + 1)] * 3):
        if c[3] == 0:
            continue
        count += 1
        msg = check(list(c), values=count % 7 == 0)
        if msg:
            bad.append(msg)
    cubics = count
    for n in (3, 4, 6, 8):
        for b in range(-30, 31):
            for a in (1, 2, 3):
                if b and (n < 8 or b > 0):
                    count += 1
                    msg = check([a] + [0] * (n - 1) + [-b], values=True)
                    if msg:
                        bad.append(msg)
    print(f"{cubics} cubics and {count - cubics} binomials checked in "
          f"{time.perf_counter() - t0:.1f} s; {len(bad)} differ")
    for msg in bad[:20]:
        print("  " + msg)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
