"""The port's roots in radicals against sympy's ``roots(multiple=False)``
(which the JAX package calls), with no sympy in the port:

- the empty and partial root sets: λ⁵ − λ − 1 has no roots sympy writes
  (``quintics=False``), (λ⁵ − λ − 1)(λ − 2) only the rational one, and a
  companion matrix of each gives the JAX package's text byte for byte;
- a seeded sample of irreducible cubics with |coefficients| ≤ 4 in every
  branch of ``roots_cubic`` (p = 0, q < 0 with a real or a complex
  radicand, the general formula with a real radicand and in the casus
  irreducibilis, a rational radicand), the reducible branches through
  ``roots_cubic`` itself, and products with cubic factors;
- the binomials a·λⁿ − b at n = 3, 4 and 6 (20 values of b, a = 1, 2, 3),
  and at n = 8 for b > 0;

each the same dict order and multiplicities, ``sympy.latex`` of every root
and of its negation equal to the port's ``cformat``, ``is_real`` True
exactly where sympy's is, and the value within 1e-25 relative of sympy's
``N(·, 40)``.
"""

import functools
import itertools
import random
from fractions import Fraction

import pytest
import sympy
from sympy.polys.polyroots import roots_cubic as sympy_roots_cubic

from linalg_solver_tpu.exact.matrix import Matrix as JMatrix
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch.exact import Matrix as TMatrix
from linalg_solver_tpu_torch.exact import radicals
from linalg_solver_tpu_torch.utils import trace as ttrace

from tools.sweep_radicals import text_differs
from torch_text_cases import fraction_rows, sympy_rows

X = sympy.symbols("x")


@pytest.fixture(autouse=True)
def python_engine(monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")


def _same(port_list, sympy_list):
    """Root lists (or dict items) equal: text, negation, multiplicity,
    sympy's ``is_real is True``, value."""
    msg = text_differs(port_list, sympy_list)
    assert msg is None, msg


def _check(coeffs):
    deg = len(coeffs) - 1
    port = radicals.radical_roots({deg - i: c for i, c in enumerate(coeffs)
                                   if c})
    want = sympy.roots(sympy.Poly([sympy.Integer(c) for c in coeffs], X),
                       multiple=False)
    _same(list(port.items()), list(want.items()))
    return port


def _jax_and_port_text(rows):
    jtext = jtrace.capture_logs(
        lambda: JMatrix(sympy_rows(rows)).eigenvalues())
    ttext = ttrace.capture_logs(
        lambda: TMatrix(fraction_rows(rows)).eigenvalues())
    jbox, tbox = [], []
    jtrace.capture_logs(lambda: jbox.append(
        JMatrix(sympy_rows(rows)).diagonalize()))
    ttrace.capture_logs(lambda: tbox.append(
        TMatrix(fraction_rows(rows)).diagonalize()))
    jdiag = jtrace.capture_logs(lambda: jtrace.log(r"%s", jbox[0]))
    tdiag = ttrace.capture_logs(lambda: ttrace.log(r"%s", tbox[0]))
    return jtext, ttext, jdiag, tdiag


def _companion(coeffs):
    """The companion matrix of the monic polynomial ``coeffs`` (highest
    first)."""
    n = len(coeffs) - 1
    rows = [[0] * n for _ in range(n)]
    for i in range(1, n):
        rows[i][i - 1] = 1
    for i in range(n):
        rows[i][n - 1] = -coeffs[n - i]
    return rows


@pytest.mark.parametrize("coeffs,want", [
    ([1, 0, 0, 0, -1, -1], {}),                       # λ⁵ − λ − 1
    ([1, -2, 0, 0, -1, 1, 2], {2: 1}),                # (λ⁵ − λ − 1)(λ − 2)
])
def test_empty_and_partial_root_sets_match_jax(coeffs, want):
    assert _check(coeffs) == want
    jtext, ttext, jdiag, tdiag = _jax_and_port_text(_companion(coeffs))
    assert ttext == jtext
    assert tdiag == jdiag and "Neúspěšná" in tdiag


def _branch(c):
    """``roots_cubic``'s branch for an irreducible a·x³ + b·x² + c·x + d."""
    _, a, b, cc = [Fraction(x, c[0]) for x in c]
    p = b - a * a / 3
    q = cc - a * b / 3 + 2 * a ** 3 / 27
    if p == 0:
        return "p0"
    if q < 0:
        disc = q * q / 4 + p ** 3 / 27
    else:
        d0, d1 = a * a - 3 * b, 2 * a ** 3 - 9 * a * b + 27 * cc
        disc = d1 * d1 - 4 * d0 ** 3
    s = radicals._squarefree(disc.numerator * disc.denominator)
    if s[1] == 1:
        return "rational-radicand"
    kind = "real" if disc > 0 else "complex"
    return ("qneg-" if q < 0 else "general-") + kind


@functools.lru_cache(maxsize=None)
def _irreducible_cubics():
    pool = {}
    for c in itertools.product(range(1, 5), range(-4, 5), range(-4, 5),
                               range(-4, 5)):
        c = list(c)
        if c[3] == 0:
            continue
        f = sympy.Poly(c, X)
        if len(f.factor_list()[1]) == 1 and f.factor_list()[1][0][1] == 1:
            pool.setdefault(_branch(c), []).append(c)
    return pool


BRANCH_SAMPLE = {"p0": 6, "qneg-real": 7, "qneg-complex": 7,
                 "general-real": 7, "general-complex": 7,
                 "rational-radicand": 6}


@pytest.mark.parametrize("branch", sorted(BRANCH_SAMPLE))
def test_irreducible_cubics_match_sympy(branch):
    rng = random.Random(2026)
    sample = rng.sample(_irreducible_cubics()[branch], BRANCH_SAMPLE[branch])
    for c in sample:
        got = _check(c)
        assert sum(got.values()) == 3
        assert all(r.minpoly == tuple(radicals._primitive(c)) for r in got)


def test_roots_cubic_reducible_branches_and_cubic_factors():
    # roots_cubic itself on the branches an irreducible cubic never takes
    for c in ([1, -3, 1, 1],          # q = 0, p ≠ 0
              [1, -3, 3, -1],         # p = q = 0
              [2, 3, -5, 0],          # c = 0
              [1, 0, -2, 0],
              [1, 1, 1, -3]):         # a rational root, general formula
        port = radicals.roots_cubic(c)
        want = sympy_roots_cubic(sympy.Poly(c, X))
        _same([(r, 1) for r in port], [(r, 1) for r in want])
    # cubic factors with multiplicities beside other factors
    rng = random.Random(17)
    for _ in range(8):
        p = sympy.Poly([rng.choice([-2, 1, 3])], X)
        p *= sympy.Poly([1] + [rng.choice([-2, -1, 1, 2]) for _ in range(3)],
                        X) ** rng.choice([1, 2])
        p *= sympy.Poly([1, rng.randint(-3, 3), rng.randint(-3, 3)], X)
        p *= sympy.Poly([rng.randint(1, 2), rng.randint(-3, 3)], X)
        _check([int(v) for v in p.all_coeffs()])


def test_binomials_match_sympy():
    rng = random.Random(6)
    bases = [2, -2, 3, -3, 4, 8, -8, 12, 16, 18, -27, 64, 81, 100]
    bases += [rng.randint(-60, 60) or 5 for _ in range(6)]
    for n in (3, 4, 6, 8):
        for b in bases:
            for lead in (1, 2, 3):
                if n < 8 or b > 0:
                    _check([lead] + [0] * (n - 1) + [-b])


def test_only_rational_and_float_coefficients_are_solved():
    """A float coefficient beside rational ones takes sympy's RR domain
    (``nroots``); a radical or complex coefficient (sympy's EX) is not
    ported and raises, rather than being rounded to a float."""
    assert list(radicals.radical_roots({2: 1, 0: -4.0})) == [-2.0, 2.0]
    sqrt2 = radicals._sqrt(Fraction(2))
    for other in (sqrt2, 1j, complex(2, 0)):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            radicals.radical_roots({2: 1, 1: other, 0: -1})
