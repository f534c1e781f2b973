"""The port's exact eigen stack against the JAX package's (sympy's
``roots``, ``latex`` and ``simplify``), with no sympy in the port:

- ``radical_roots`` on every quadratic a·x² + b·x + c with |a|, |b|, |c|
  ≤ 6 and on seeded products of linear, quadratic and binomial factors:
  the same roots, in sympy's order, with the same multiplicities, each
  root and its negation written as ``sympy.latex`` writes them;
- ``Matrix.eigenvalues`` on 40 seeded 2×2 / 3×3 matrices (repeated, zero,
  real-quadratic and complex roots; ``real_only`` on a quarter of them):
  the whole logged text byte for byte (the characteristic matrix, the
  planned determinant over polynomials, the polynomial, its factored form
  and the summary) and the returned dict;
- ``eigenvalues_with_geometric_multiplicities`` and ``diagonalize`` on
  the random builders' diagonalizable and Jordan 3×3 / 4×4 matrices;
- ``NotImplementedError`` for λ³ − 2 and for a non-rational eigenspace.

Both planner engines are the Python one (``LINALG_TPU_NATIVE=0``): the
JAX package takes its native engine only where its library was built.
"""

import itertools
import random
from fractions import Fraction

import pytest
import sympy

import linalg_solver_tpu.exact.random_matrix as jrm
import linalg_solver_tpu_torch.exact.random_matrix as trm
from linalg_solver_tpu.exact.matrix import Matrix as JMatrix
from linalg_solver_tpu.exact.polynomial import Polynomial as JPoly
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch.exact import Matrix as TMatrix
from linalg_solver_tpu_torch.exact import Polynomial as TPoly
from linalg_solver_tpu_torch.utils import trace as ttrace
from linalg_solver_tpu_torch.utils.fmt import cformat

from torch_text_cases import fraction_rows, sympy_rows

X = sympy.symbols("x")


@pytest.fixture(autouse=True)
def python_engine(monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")


def _sympy_roots(coeffs):
    """sympy's roots of the polynomial with these coefficients (highest
    first) as [(latex, latex of the negation, multiplicity)]."""
    got = sympy.roots(sympy.Poly([sympy.Integer(c) for c in coeffs], X),
                      multiple=False)
    return [(sympy.latex(r), sympy.latex(-r), m) for r, m in got.items()]


def _port_roots(coeffs):
    deg = len(coeffs) - 1
    poly = TPoly({deg - i: c for i, c in enumerate(coeffs)})
    return [(cformat(r), cformat(-r), m)
            for r, m in poly.radical_roots().items()]


def test_every_small_quadratic_matches_sympy():
    for a, b, c in itertools.product(range(-6, 7), repeat=3):
        if a:
            assert _port_roots([a, b, c]) == _sympy_roots([a, b, c]), (
                a, b, c)


def _factor_products(count, seed):
    """Seeded products of linear, quadratic and binomial factors with
    repeats, signs and zero roots, whose roots all lie in ℚ(√d)."""
    rng = random.Random(seed)
    binomials = ([1, 0, 0, -8], [1, 0, 0, 8], [1, 0, 0, 0, -4],
                 [1, 0, 0, 0, 4], [1, 0, 0, 0, -1], [2, 0, -3])
    out = []
    while len(out) < count:
        p = sympy.Poly([rng.choice([-2, -1, 1, 3])], X)
        for _ in range(rng.randint(1, 3)):
            kind = rng.random()
            if kind < 0.4:
                f = [rng.randint(1, 3), rng.randint(-6, 6)]
            elif kind < 0.85:
                f = [rng.randint(1, 3), rng.randint(-6, 6), rng.randint(-6, 6)]
            else:
                f = rng.choice(binomials)
            p = p * sympy.Poly(f, X) ** rng.choice([1, 1, 1, 2])
        p = p * sympy.Poly([1, 0], X) ** rng.choice([0, 0, 1, 2])
        coeffs = [int(c) for c in p.all_coeffs()]
        try:
            _port_roots(coeffs)
        except NotImplementedError:
            continue
        out.append(coeffs)
    return out


def test_factor_products_match_sympy():
    cases = _factor_products(150, seed=17)
    cases += [[1, 0, 0, -8], [-1, 0, 0, -8], [1, 0, 0, 0, -4],
              [1, 0, 0, 0, 4], [1, 0, 0, 0, -1], [1, 0, 0, 0, 0, 0, -1],
              [1, 0, 0, 0, -36], [1, -2, -8], [4, 0, -1], [1, 0, -4],
              [2, -5, 2], [6, 1, -1], [3, 0, 0], [1, 0, 1, 0]]
    for coeffs in cases:
        assert _port_roots(coeffs) == _sympy_roots(coeffs), coeffs


def _unimodular(rng, n):
    """An integer matrix with an integer inverse, drawn as the builders
    draw it (U before L)."""
    state = random.getstate()
    random.seed(rng.randint(0, 10 ** 6))
    m = trm.gen_unimodular_matrix(n)
    random.setstate(state)
    return [[int(x) for x in row] for row in m.items]


def _conjugate(P, form):
    """P⁻¹·form·P over the integers (P unimodular)."""
    Pi = TMatrix(fraction_rows(P)).inverse().items
    n = len(P)
    prod = [[sum(Pi[i][k] * form[k][j] for k in range(n)) for j in range(n)]
            for i in range(n)]
    out = [[sum(prod[i][k] * P[k][j] for k in range(n)) for j in range(n)]
           for i in range(n)]
    return [[int(x) for x in row] for row in out]


def eigen_cases(count=40, seed=2026):
    """Seeded 2×2 and 3×3 integer matrices: a rational root beside a 2×2
    block (real-quadratic, complex, rational or repeated roots), plain
    2×2 matrices, and diagonal / Jordan forms with zero and repeated
    eigenvalues, each conjugated by a unimodular matrix."""
    rng = random.Random(seed)
    cases = []
    while len(cases) < count:
        kind = len(cases) % 4
        if kind == 0:
            cases.append([[rng.randint(-5, 5) for _ in range(2)]
                          for _ in range(2)])
            continue
        r = rng.choice([-2, 0, 1, 3])
        if kind == 1:
            blk = [[rng.randint(-4, 4) for _ in range(2)] for _ in range(2)]
        elif kind == 2:
            a, b = rng.randint(-3, 3), rng.choice([-2, -1, 1, 2, 3])
            blk = [[a, -b], [b, a]]
        else:
            lam = rng.choice([-1, 0, 2])
            blk = [[lam, rng.choice([0, 1])], [0, lam]]
            r = rng.choice([lam, -3])
        form = [[r, 0, 0], [0] + blk[0], [0] + blk[1]]
        cases.append(_conjugate(_unimodular(rng, 3), form))
    return cases


CASES = eigen_cases()


def _eigen_texts(rows, real_only):
    jbox, tbox = [], []
    jtext = jtrace.capture_logs(lambda: jbox.append(
        JMatrix(sympy_rows(rows)).eigenvalues(real_only=real_only)))
    ttext = ttrace.capture_logs(lambda: tbox.append(
        TMatrix(fraction_rows(rows)).eigenvalues(real_only=real_only)))
    return jtext, ttext, jbox[0], tbox[0]


@pytest.mark.parametrize("part", range(4))
def test_eigenvalues_text_matches(part):
    for i, rows in enumerate(CASES[part::4]):
        real_only = i % 4 == 3
        jtext, ttext, jroots, troots = _eigen_texts(rows, real_only)
        assert ttext == jtext, rows
        assert ([(sympy.latex(r), m) for r, m in jroots.items()]
                == [(cformat(r), m) for r, m in troots.items()]), rows


def test_eigen_cases_cover_the_root_kinds():
    kinds = set()
    for rows in CASES:
        roots = TMatrix(fraction_rows(rows)).eigenvalues
        got = ttrace.capture_logs(lambda: kinds.update(
            type(r).__name__ + ("-real" if getattr(r, "is_real", True)
                                else "-complex")
            for r in roots()))
        assert got
    assert {"int-real", "Surd-real", "Surd-complex"} <= kinds


DIAG_BUILDS = [
    lambda m: m.gen_diagonalizable_matrix(3, [(5, 1), (2, 1), (-5, 1)]),
    lambda m: m.gen_diagonalizable_matrix(3, [(2, 2), (-1, 1)]),
    lambda m: m.gen_diagonalizable_matrix(4, [(0, 1), (1, 2), (-3, 1)]),
    lambda m: m.gen_matrix_with_jordan_blocks(3, [(2, 2), (-1, 1)]),
    lambda m: m.gen_matrix_with_jordan_blocks(4, [(1, 3), (0, 1)]),
    lambda m: m.gen_matrix_with_jordan_blocks(4, [(3, 2), (3, 2)]),
]


def _rational_rows(m):
    return [[Fraction(int(x.p), int(x.q)) if hasattr(x, "q") else
             Fraction(x) for x in row] for row in m.items]


def test_diagonalize_matches():
    for k, build in enumerate(DIAG_BUILDS):
        random.seed(100 + k)
        rows = _rational_rows(build(jrm))
        jtext = jtrace.capture_logs(lambda: jtrace.log(
            r"%s", JMatrix(sympy_rows(rows)).diagonalize()))
        ttext = ttrace.capture_logs(lambda: ttrace.log(
            r"%s", TMatrix(fraction_rows(rows)).diagonalize()))
        assert ttext == jtext, rows


def test_geometric_multiplicities_match():
    for k, build in enumerate(DIAG_BUILDS):
        random.seed(200 + k)
        rows = _rational_rows(build(jrm))
        box = []
        jtrace.capture_logs(lambda: box.append(
            JMatrix(sympy_rows(rows))
            .eigenvalues_with_geometric_multiplicities()))
        ttrace.capture_logs(lambda: box.append(
            TMatrix(fraction_rows(rows))
            .eigenvalues_with_geometric_multiplicities()))
        want = [(sympy.latex(e), am) for e, am in box[0].items()]
        assert [(cformat(e), am) for e, am in box[1].items()] == want
    # simplify is the identity on exact entries, as sympy.simplify
    m = TMatrix([[Fraction(1, 2), 3], [0, Fraction(-4, 6)]])
    assert m.simplify() is m and m.items[1][1] == Fraction(-2, 3)


def test_cube_root_factor_and_radical_eigenspace_raise():
    companion = [[0, 0, 2], [1, 0, 0], [0, 1, 0]]   # λ³ − 2
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        ttrace.capture_logs(
            lambda: TMatrix(fraction_rows(companion)).eigenvalues())
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        TPoly({3: 1, 0: -2}).radical_roots()
    # the JAX package returns cube roots there, which the port does not
    assert len(JPoly({3: 1, 0: -2}).radical_roots()) == 3
    quad = TMatrix(fraction_rows([[1, 2], [3, 1]]))          # 1 ± √6
    roots = []
    ttrace.capture_logs(lambda: roots.extend(quad.eigenvalues()))
    assert [cformat(r) for r in roots] == [r"1 - \sqrt{6}", r"1 + \sqrt{6}"]
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        quad.find_eigenspace(roots[0])
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        ttrace.capture_logs(quad.diagonalize)
