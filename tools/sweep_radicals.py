"""Hold the port's roots against sympy's ``roots`` (which the JAX package
calls) on five families, with no sympy in the port:

- every cubic a·x³ + b·x² + c·x + d with 1 ≤ a ≤ K, |b|, |c|, |d| ≤ K,
  d ≠ 0, where K = ``BOUND`` = 4 (2,592 cubics, reducible ones included);
- every monic quartic x⁴ + a·x³ + b·x² + c·x + d with |a|, |b|, |c|,
  |d| ≤ 3, d ≠ 0 (2,058 quartics: ``roots_quartic``'s branches,
  decompositions, reducible ones);
- the cyclotomic polynomials Φₙ, n ≤ 30;
- the binomials a·xⁿ − b for 2 ≤ n ≤ 12, a = 1, 2, 3 and 20 values of b;
- 200 seeded polynomials of degree 2–6 with float coefficients
  (``nroots``).

For each: the dict's order and multiplicities, the LaTeX of each root and
of its negation, ``is_real`` True exactly where sympy's is, and (every 7th
polynomial of the first two families, every one of the others) the value
within 1e-25 of sympy's ``N(·, 40)`` (float roots: equal to sympy's).  A
development check on the CPU; it needs sympy, which the port does not.

    PYTHONPATH=. python3 tools/sweep_radicals.py [--families cubic,quartic,
        cyclotomic,binomial,float]

Prints, per family, the counts checked, the polynomials the port does not
write (``NotImplementedError`` citing ROADMAP.md queue 1 item 7), those
whose text differs only in the term order and branch that sympy takes
from the rounding noise of ``evalf`` (Ferrari's formula with the cube
root of a complex or negative number, not ported: ROADMAP.md queue 1
item 7; the same number of roots, each sympy's in value with the same
multiplicity and ``is_real``) and the mismatches; exits 1 on any
mismatch.
"""

import argparse
import itertools
import random
import sys
import time
from decimal import Decimal
from typing import Optional

import sympy

from linalg_solver_tpu_torch.exact import radicals
from linalg_solver_tpu_torch.exact.radexpr import numeric
from linalg_solver_tpu_torch.utils.fmt import cformat

X = sympy.symbols("x")
BOUND = 4


def port_is_real(r) -> bool:
    """Whether ``eigenvalues(real_only=True)`` keeps the port's root."""
    return getattr(r, "is_real", True) is True


def sympy_values(roots):
    """(real, imaginary, multiplicity, is_real) of each root of a sympy
    ``{root: multiplicity}`` (the JAX package's ``radical_roots``), the
    value at 40 digits."""
    out = []
    for r, m in roots.items():
        w = sympy.N(r, 40)
        out.append((Decimal(str(sympy.re(w))), Decimal(str(sympy.im(w))), m,
                    r.is_real is True))
    return out


def _near(re_, im_, w_re, w_im) -> bool:
    return abs(w_re - re_) + abs(w_im - im_) <= Decimal("1e-25") * (
        1 + abs(w_re) + abs(w_im))


def roots_differ(port, values) -> Optional[str]:
    """None where the port's ``{root: multiplicity}`` and sympy's
    ``values`` (``sympy_values``) are the same roots: each port root
    within 1e-25 relative of exactly one of sympy's, one to one, with the
    same multiplicity and ``is_real`` (so the same set under
    ``real_only``); else what differs."""
    if len(port) != len(values):
        return f"{len(port)} roots against sympy's {len(values)}"
    taken = set()
    for r, m in port.items():
        re_, im_ = numeric(r, 45)
        hits = [i for i, (w_re, w_im, _, _) in enumerate(values)
                if _near(re_, im_, w_re, w_im)]
        if len(hits) != 1 or hits[0] in taken:
            return f"{cformat(r)} matches sympy's roots {hits}"
        taken.add(hits[0])
        if values[hits[0]][2:] != (m, port_is_real(r)):
            return (f"{cformat(r)}: multiplicity and is_real "
                    f"{(m, port_is_real(r))} against {values[hits[0]][2:]}")
    return None


def ferrari_complex(coeffs) -> bool:
    """Whether a factor of ``coeffs`` (rational, highest first) takes
    Ferrari's formula with the cube root of a complex or negative number
    (``radicals.quartic_branch``): sympy then orders and branches the
    terms of its roots by the rounding noise of ``evalf`` in imaginary
    parts that cancel exactly, which the port does not emulate (ROADMAP.md
    queue 1 item 7)."""
    for f, _ in radicals._factor_list(radicals._primitive(list(coeffs))):
        if len(f) == 5 and len(radicals._decompose(f)) == 1 \
                and radicals.quartic_branch(f) == "ferrari complex":
            return True
    return False


def check(coeffs, values):
    """``("same", None)`` where the port writes sympy's roots byte for
    byte; ``("noise", msg)`` where they differ only in term order and
    branch (``ferrari_complex``, the same roots by ``roots_differ``);
    else ``("differ", msg)``."""
    deg = len(coeffs) - 1
    port = radicals.radical_roots({deg - i: c for i, c in enumerate(coeffs)
                                   if c})
    want = sympy.roots(sympy.Poly(coeffs, X), multiple=False)
    msg = text_differs(list(port.items()), list(want.items()), values)
    if msg is None:
        return "same", None
    if ferrari_complex(coeffs):
        why = roots_differ(port, sympy_values(want))
        if why is None:
            return "noise", f"{coeffs}: {msg}"
        msg = why
    return "differ", f"{coeffs}: {msg}"


def text_differs(port, want, values=True) -> Optional[str]:
    """None where the port's (root, multiplicity) pairs are sympy's
    ``want`` byte for byte: in order, each with the same multiplicity,
    LaTeX (and that of its negation) and ``is_real``, and (``values``)
    within 1e-25 relative of sympy's ``N(·, 40)``; else what differs."""
    if len(port) != len(want):
        return f"{len(port)} roots against sympy's {len(want)}"
    for (rp, mp), (rs, ms) in zip(port, want):
        if (mp, cformat(rp), cformat(-rp)) != (ms, sympy.latex(rs),
                                               sympy.latex(-rs)):
            return f"{cformat(rp)} against {sympy.latex(rs)}"
        if port_is_real(rp) != (rs.is_real is True):
            return f"is_real differs on {cformat(rp)}"
        if values:
            (w_re, w_im, _, _), = sympy_values({rs: ms})
            if not _near(*numeric(rp, 45), w_re, w_im):
                return f"the value of {cformat(rp)} differs"
    return None


def cubics():
    for c in itertools.product(range(1, BOUND + 1),
                               *[range(-BOUND, BOUND + 1)] * 3):
        if c[3]:
            yield list(c)


def quartics():
    for c in itertools.product([1], *[range(-3, 4)] * 4):
        if c[4]:
            yield list(c)


def cyclotomics():
    for n in range(1, 31):
        yield [int(v) for v in
               sympy.Poly(sympy.cyclotomic_poly(n, X), X).all_coeffs()]


def binomials():
    bases = [1, 2, 3, 4, 5, 8, 16, 27, 32, 81]
    for n in range(2, 13):
        for b in bases + [-v for v in bases]:
            for a in (1, 2, 3):
                yield [a] + [0] * (n - 1) + [-b]


def floats():
    rng = random.Random(2026)
    for _ in range(200):
        deg = rng.randint(2, 6)
        c = [rng.choice([1, 1.0, -1.0, 2.0, round(rng.uniform(-5, 5), 3)])]
        for _ in range(deg):
            c.append(rng.choice([float(rng.randint(-9, 9)),
                                 round(rng.uniform(-9, 9), 2),
                                 rng.randint(-9, 9) / 3]))
        if c[-1] == 0:
            c[-1] = 1.0
        yield c


FAMILIES = {"cubic": (cubics, 7), "quartic": (quartics, 7),
            "cyclotomic": (cyclotomics, 1), "binomial": (binomials, 1),
            "float": (floats, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default=",".join(FAMILIES))
    args = ap.parse_args()
    failed = False
    for name in args.families.split(","):
        make, every = FAMILIES[name]
        t0 = time.perf_counter()
        bad, skipped, noise, count = [], [], [], 0
        for c in make():
            count += 1
            try:
                verdict, msg = check(c, values=count % every == 0)
            except NotImplementedError as e:
                skipped.append(f"{c}: {str(e)[:120]}")
                continue
            {"noise": noise, "differ": bad}.get(verdict, []).append(msg)
        failed |= bool(bad)
        print(f"{name}: {count} checked in {time.perf_counter() - t0:.1f} s;"
              f" {len(skipped)} not ported; {len(noise)} differ only in the "
              f"term order and branch of sympy's evalf noise; {len(bad)} "
              f"differ",
              flush=True)
        for msg in skipped[:10] + bad[:20]:
            print("  " + msg[:400], flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
