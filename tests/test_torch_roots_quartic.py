"""The port's ``roots_quartic`` and ``_try_decompose`` against the JAX
package's ``Polynomial.radical_roots`` (``sympy.roots``), with no sympy in
the port.  The population is every monic quartic x⁴ + a·x³ + b·x² + c·x + d
with |a|, |b|, |c|, |d| ≤ 3, d ≠ 0, sorted by the branch sympy takes
(``radicals.quartic_branch``):

- Descartes–Euler, Ferrari with p = 0 (q of either sign: ``\\sqrt[3]{-17}``
  among them) and Ferrari with a real cube root (a seeded sample): the
  same dict order and multiplicities, ``sympy.latex`` of every root and
  its negation, ``is_real`` (sympy's assumptions, decided by its 2-bit
  ``evalf``) and the value within 1e-25 relative of sympy's ``N(·, 40)``;
- the quasi-symmetric case (c/a)² = d, with ``roots_quadratic`` over EX
  and its ``simplify`` (the shorter of b² − 4c and its expansion by
  ``count_ops``), and the decompositions g(h(x)) (binomials and
  quadratics over EX): every one equal to sympy, or raising
  ``NotImplementedError`` citing ROADMAP.md queue 1 item 7 (a complex
  coefficient over EX, a root written with atan);
- Ferrari with the cube root of a complex or negative number, where sympy
  orders and branches the terms by the rounding noise of its ``evalf``
  (not ported: ROADMAP.md queue 1 item 7): the same roots in value, with
  the same multiplicities and ``is_real`` (``sweep_radicals.roots_differ``),
  so the same ``real_only`` set, and each a root at 40 digits;
- ``roots_quartic`` itself on the branches only reducible quartics reach
  (a zero root, f = 0, g = 0, a rational quasi-symmetric z).
"""

import functools
import itertools
import random
from decimal import Decimal, localcontext

import pytest
import sympy
from sympy.polys.polyroots import roots_quartic as sympy_roots_quartic

from linalg_solver_tpu.exact.polynomial import Polynomial as JPoly
from linalg_solver_tpu_torch.exact import radicals
from linalg_solver_tpu_torch.exact.radexpr import numeric
from linalg_solver_tpu_torch.utils import fmt as tfmt
from tools.sweep_radicals import roots_differ, sympy_values, text_differs

X = sympy.symbols("x")


def _same(port_items, sympy_items):
    msg = text_differs(port_items, sympy_items)
    assert msg is None, msg


def _check(c):
    powers = {4 - i: v for i, v in enumerate(c) if v}
    port = radicals.radical_roots(dict(powers))
    want = JPoly(dict(powers)).radical_roots()
    _same(list(port.items()), list(want.items()))
    return port


def _branch(c):
    f = radicals._factor_list(c)
    if len(f) != 1 or f[0][1] != 1:
        return "reducible"
    if len(radicals._decompose(c)) > 1:
        return "decomposition"
    return radicals.quartic_branch(c)


@functools.lru_cache(maxsize=None)
def _population():
    out = {}
    for c in itertools.product([1], *[range(-3, 4)] * 4):
        if c[4]:
            out.setdefault(_branch(list(c)), []).append(list(c))
    return out


@pytest.mark.parametrize("branch,count", [("euler", 20),
                                          ("ferrari p = 0", 8),
                                          ("ferrari real", 24)],
                         ids=["euler-20", "p0-8", "ferrari-real-24"])
def test_quartic_branches_match_jax(branch, count):
    pool = _population()[branch]
    for c in random.Random(2026).sample(pool, min(count, len(pool))):
        got = _check(c)
        assert sum(got.values()) == 4
        assert all(r.minpoly == tuple(c) for r in got)


@pytest.mark.parametrize("branch", ["quasi-symmetric", "decomposition"],
                         ids=["quasi", "decomposition"])
def test_quasi_symmetric_and_decompositions_match_jax(branch):
    ported = 0
    for c in _population()[branch]:
        try:
            _check(c)
        except NotImplementedError as e:
            assert "queue 1 item 7" in str(e)
            continue
        ported += 1
    assert ported >= 0.9 * len(_population()[branch])


def test_named_decompositions_match_jax():
    for c, first in (([1, 0, -2, 0, -2], r"- i \sqrt{-1 + \sqrt{3}}"),
                     ([1, 0, -10, 0, 1], r"- \sqrt{5 - 2 \sqrt{6}}"),
                     ([1, -2, -2, 3, -3], None),
                     ([1, 2, 3, 2, 3], None)):
        got = _check(c)
        if first:
            assert tfmt.cformat(next(iter(got))) == first


def test_ferrari_with_complex_cube_roots_gives_the_roots():
    pool = _population()["ferrari complex"]
    assert [1, 0, 0, 1, 1] in pool and [1, -3, -1, 3, -1] in pool
    for c in [[1, 0, 0, 1, 1], [1, -3, -1, 3, -1]] + \
            random.Random(7).sample(pool, 12):
        powers = {4 - i: v for i, v in enumerate(c) if v}
        got = radicals.radical_roots(dict(powers))
        assert roots_differ(
            got, sympy_values(JPoly(dict(powers)).radical_roots())) is None
        assert sum(got.values()) == 4
        with localcontext() as ctx:
            ctx.prec = 50
            for r in got:
                re_, im_ = numeric(r, 45)
                a = b = Decimal(0)
                for x in c:
                    a, b = a * re_ - b * im_ + x, a * im_ + b * re_
                assert abs(a) + abs(b) < Decimal(10) ** -40


def test_roots_quartic_on_reducible_branches():
    for c in ([1, 2, -3, 1, 0],          # d = 0
              [1, 4, 4, 0, -1],          # f = 0 (x + 1)² shifted
              [1, 0, -5, 2, 0],
              [2, 6, 7, 3, 0],
              [1, 0, -2, -8, 0],         # g = 0 after the shift
              [1, 4, 6, 4, 1],           # (c/a)² = d, z rational
              [1, 3, 4, 3, 1]):
        port = radicals.roots_quartic(c)
        want = sympy_roots_quartic(sympy.Poly(c, X))
        _same([(r, 1) for r in port], [(r, 1) for r in want])
