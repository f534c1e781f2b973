"""The port's eigenspaces, geometric multiplicities and diagonalizations
for irrational eigenvalues against the JAX package (``sympy.linsolve``,
``Matrix.inv`` and ``simplify``):

- over one real field ℚ(√d): ``find_eigenspace``,
  ``eigenvalues_with_geometric_multiplicities`` and ``diagonalize``'s
  result byte for byte, and its log up to the products P⁻¹·A·P (which the
  JAX package logs with ``Matrix.inv``'s unsimplified entries);
- over ℚ(√d) with d < 0, and with eigenvalues in two fields: the
  eigenspaces byte for byte, P⁻¹ and D equal in value to the JAX
  package's quotients (proved with sympy here), D diagonal;
- geometric multiplicities of cubic-radical eigenvalues over ℚ[t]/(f):
  the JAX package's where its ``linsolve`` takes seconds, else a rank
  computed with sympy over ``QQ.algebraic_field`` of a root of f;
- the failure table of the non-diagonalizable [[C, I], [0, C]] with C the
  companion of λ³ − 2, byte for byte;
- ``[[0, 3, 1], [3, 3, 0], [0, 1, 3]]``, where the JAX package raises
  ``PolynomialDivisionFailed`` and the port writes the factored form;
- a real cubic-formula root alone (``real_only``): the JAX package's text
  but for its factored line, which the port does not write yet (ROADMAP.md
  queue 1 item 7); radical roots that do not multiply to their factor
  raise through ``eigenvalues``;
- ``tests/data_torch/eigen_radicals.tex`` (``chip_smoke.py`` phase 78):
  the port writes it byte for byte, and so does the JAX package but for
  that factored line and the P⁻¹ and D it writes differently by design
  (ROADMAP.md §3).
"""

import pathlib
import random
from fractions import Fraction

import pytest
import sympy
from sympy.polys.matrices import DomainMatrix

import chip_smoke as cs
from linalg_solver_tpu.exact.matrix import Matrix as JMatrix
from linalg_solver_tpu.utils import fmt as jfmt
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch.exact import Matrix as TMatrix
from linalg_solver_tpu_torch.exact import Surd
from linalg_solver_tpu_torch.exact.polynomial import LoneRootQuotient
from linalg_solver_tpu_torch.exact.polynomial import Polynomial as TPolynomial
from linalg_solver_tpu_torch.exact.radexpr import Radical
from linalg_solver_tpu_torch.utils import fmt as tfmt
from linalg_solver_tpu_torch.utils import trace as ttrace

from torch_text_cases import fraction_rows, sympy_rows

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / cs.RADICAL_GOLDEN
X = sympy.symbols("x")


@pytest.fixture(autouse=True)
def python_engine(monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")


def _port_eig(rows):
    box = []
    ttrace.capture_logs(lambda: box.append(
        TMatrix(fraction_rows(rows)).eigenvalues()))
    return box[0]


def _seeded(kind, count, seed=2026):
    """Seeded 2×2 / 3×3 randint(-3, 3) matrices whose irrational
    eigenvalues all lie in one real ℚ(√d) (``kind="real"``) or in one
    ℚ(√d) with d < 0 (``"complex"``)."""
    rng = random.Random(seed)
    out = []
    while len(out) < count:
        n = rng.choice([2, 3])
        rows = [[rng.randint(-3, 3) for _ in range(n)] for _ in range(n)]
        roots = list(_port_eig(rows))
        fields = {r.d for r in roots if isinstance(r, Surd)}
        if any(isinstance(r, Radical) for r in roots) or len(fields) != 1:
            continue
        if (fields.pop() > 0) == (kind == "real"):
            out.append(rows)
    return out


def _diagonalize(rows):
    """Both packages' diagonalize: (result text, whole log, eigen log,
    result) each."""
    out = []
    for M, trace, items in ((JMatrix, jtrace, sympy_rows(rows)),
                            (TMatrix, ttrace, fraction_rows(rows))):
        box = []
        log = trace.capture_logs(lambda: box.append(M(items).diagonalize()))
        eig = trace.capture_logs(lambda: M(items).eigenvalues())
        text = trace.capture_logs(lambda: trace.log(r"%s", box[0]))
        out.append((text, log, eig, box[0]))
    return out


def _eigenspaces(rows):
    """Each eigenvalue's eigenspace as text, from both packages."""
    texts = []
    for M, trace, fmt, items in ((JMatrix, jtrace, jfmt, sympy_rows(rows)),
                                 (TMatrix, ttrace, tfmt,
                                  fraction_rows(rows))):
        box = []
        trace.capture_logs(lambda: box.append(M(items).eigenvalues()))
        texts.append([(fmt.cformat(e), fmt.cformat(
            M(items).find_eigenspace(e))) for e in box[0]])
    return texts


def _to_sympy(x):
    if isinstance(x, Surd):
        return sympy.Rational(x.p.numerator, x.p.denominator) + sympy.Rational(
            x.q.numerator, x.q.denominator) * sympy.sqrt(x.d)
    x = Fraction(x)
    return sympy.Rational(x.numerator, x.denominator)


def _equal(a, b) -> bool:
    """a = b proved with sympy (radicals out of the denominators, then
    expansion, then ``simplify``)."""
    d = sympy.expand(sympy.radsimp(sympy.sympify(a) - _to_sympy(b)))
    return d == 0 or sympy.simplify(d) == 0


REAL = [[[1, 2], [3, 4]], [[2, 1, 1], [1, 3, 0], [1, 0, 1]],
        [[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 1, 2], [0, 0, 3, 4]]]


@pytest.mark.parametrize("cases", ["fixed", "seeded"])
def test_one_real_field_matches_jax_byte_for_byte(cases):
    for rows in (REAL if cases == "fixed" else _seeded("real", 6)):
        spaces = _eigenspaces(rows)
        assert spaces[1] == spaces[0], rows
        (jt, jlog, jeig, jres), (tt, tlog, teig, tres) = _diagonalize(rows)
        assert tt == jt, rows
        assert teig == jeig and jlog.startswith(jeig) and \
            tlog.startswith(teig)
        assert tres.success


@pytest.mark.parametrize("cases", ["complex", "two-fields"])
def test_complex_and_two_field_values_match_jax(cases):
    rows_list = (_seeded("complex", 4) + [[[1, 1], [-1, 2]]]
                 if cases == "complex" else
                 [[[1, 2, 1, 0], [3, 4, 0, 1], [0, 0, 2, 1], [0, 0, 1, 1]]])
    for rows in rows_list:
        spaces = _eigenspaces(rows)
        assert spaces[1] == spaces[0], rows
        (jt, _, jeig, jres), (tt, _, teig, tres) = _diagonalize(rows)
        assert teig == jeig and tres.success and jres.success
        # the table and P byte for byte; P⁻¹ and D equal in value
        assert tt.split(r"\[ P^{-1}")[0] == jt.split(r"\[ P^{-1}")[0], rows
        n = len(rows)
        for name in ("P_inv", "D"):
            jm, tm = getattr(jres, name), getattr(tres, name)
            for i in range(n):
                for j in range(n):
                    assert _equal(jm.items[i][j], tm.items[i][j]), \
                        (rows, name, i, j)
        assert all(tres.D.items[i][j] == 0 for i in range(n)
                   for j in range(n) if i != j)


def _sympy_geometric(rows, root):
    """n − rank(A − rI) with r the ``CRootOf`` of r's minimal polynomial
    nearest the port's root, over ``QQ.algebraic_field(r)``."""
    f = sympy.Poly(list(root.minpoly), X)
    z = complex(root)
    r = min((sympy.CRootOf(f, k) for k in range(f.degree())),
            key=lambda c: abs(complex(sympy.N(c, 30)) - z))
    K = sympy.QQ.algebraic_field(r)
    n = len(rows)
    M = DomainMatrix([[K.from_sympy(sympy.Integer(v)) for v in row]
                      for row in rows], (n, n), K)
    M = M - DomainMatrix.eye(n, K) * K.from_sympy(r)
    return n - M.rank()


def _block(a, b, c, d):
    return [ra + rb for ra, rb in zip(a, b)] + \
        [rc + rd for rc, rd in zip(c, d)]


C2 = [[0, 0, 2], [1, 0, 0], [0, 1, 0]]          # companion of λ³ − 2
I3 = [[1, 0, 0], [0, 1, 0], [0, 0, 1]]
Z3 = [[0, 0, 0]] * 3


def test_geometric_multiplicities_over_a_number_field():
    # the JAX package's linsolve finishes in seconds on these
    for rows in (C2, [[0, 0, -1], [1, 0, 3], [0, 1, 0]]):
        box = []
        jtrace.capture_logs(lambda: box.append(JMatrix(sympy_rows(rows))
            .eigenvalues_with_geometric_multiplicities()))
        ttrace.capture_logs(lambda: box.append(TMatrix(fraction_rows(rows))
            .eigenvalues_with_geometric_multiplicities()))
        assert [(tfmt.cformat(e), m) for e, m in box[1].items()] == \
            [(sympy.latex(e), m) for e, m in box[0].items()]
    # where it takes minutes (an irreducible cubic's roots in the general
    # formula), against sympy's rank over the algebraic field
    rng = random.Random(7)
    cases = [[[1, -2, -2], [3, 1, 0], [2, 1, 3]], _block(C2, Z3, Z3, C2)]
    while len(cases) < 5:
        rows = [[rng.randint(-3, 3) for _ in range(3)] for _ in range(3)]
        if all(isinstance(r, Radical) for r in _port_eig(rows)):
            cases.append(rows)
    for rows in cases:
        box = []
        ttrace.capture_logs(lambda: box.append(TMatrix(fraction_rows(rows))
            .eigenvalues_with_geometric_multiplicities()))
        for e, (alg, geom) in box[0].items():
            assert geom == _sympy_geometric(rows, e), (rows, e)
        n = len(rows)
        assert sum(g for _, g in box[0].values()) == (6 if n == 6 else 3)


def test_non_diagonalizable_cubic_radicals_print_the_failure_table():
    rows = _block(C2, I3, Z3, C2)
    (jt, jlog, _, jres), (tt, tlog, _, tres) = _diagonalize(rows)
    assert tt == jt and tlog == jlog
    assert not tres.success and "Neúspěšná" in tt
    assert [g for _, g in tres.eigenvalue_multiplicities.values()] == [1] * 3


def test_jax_division_failure_is_factored_by_the_port():
    rows = [[0, 3, 1], [3, 3, 0], [0, 1, 3]]
    with pytest.raises(sympy.polys.polyerrors.PolynomialDivisionFailed):
        jtrace.capture_logs(lambda: JMatrix(sympy_rows(rows)).eigenvalues())
    box = []
    text = ttrace.capture_logs(lambda: box.append(
        TMatrix(fraction_rows(rows)).eigenvalues()))
    want = sympy.roots(sympy.Matrix(rows).charpoly(X), multiple=False)
    assert [(tfmt.cformat(r), m) for r, m in box[0].items()] == \
        [(sympy.latex(r), m) for r, m in want.items()]
    factored = [ln for ln in text.splitlines()
                if ln.startswith("Rozložený tvar:")]
    assert len(factored) == 1 and factored[0].startswith(
        r"Rozložený tvar: $$ p(\lambda) = (-1) \cdot ({\lambda}")


def test_lone_cubic_root_and_wrong_roots_raise_apart(monkeypatch):
    """A real cubic-formula root alone (``real_only``) raises
    ``LoneRootQuotient``, which ``eigenvalues`` takes as "no factored
    line" (the JAX package's EX-domain quotient is not ported); a set of
    radical roots that does not multiply to its factor raises
    ``ArithmeticError``, which ``eigenvalues`` lets through."""
    rows = [[0, 0, 1], [1, 0, 1], [0, 1, 0]]          # λ³ − λ − 1
    char = TPolynomial({3: -1, 1: 1, 0: 1}, var=r"\lambda")
    roots = char.radical_roots()
    real = [(r, m) for r, m in roots.items() if r.is_real]
    assert len(real) == 1
    with pytest.raises(LoneRootQuotient):
        char.factor_roots(real)
    jtext = jtrace.capture_logs(
        lambda: JMatrix(sympy_rows(rows)).eigenvalues(real_only=True))
    ttext = ttrace.capture_logs(
        lambda: TMatrix(fraction_rows(rows)).eigenvalues(real_only=True))
    jlines = jtext.splitlines()
    assert sum(ln.startswith("Rozložený tvar:") for ln in jlines) == 1
    assert ttext.splitlines() == [ln for ln in jlines
                                  if not ln.startswith("Rozložený tvar:")]
    other = TPolynomial({3: 1, 1: -1, 0: 1}).radical_roots()  # λ³ − λ + 1
    wrong = dict(roots)
    del wrong[real[0][0]]
    stray = next(r for r in other if r.is_real)
    stray.minpoly = real[0][0].minpoly
    wrong[stray] = 1
    with pytest.raises(ArithmeticError):
        char.factor_roots(list(wrong.items()))
    monkeypatch.setattr(TPolynomial, "radical_roots", lambda self: wrong)
    with pytest.raises(ArithmeticError):
        ttrace.capture_logs(
            lambda: TMatrix(fraction_rows(rows)).eigenvalues())


def _sections(text):
    out, key = {}, None
    for line in text.splitlines():
        if line.startswith("%% "):
            key = tuple(line[3:].rsplit(" ", 1))
            out[key] = []
        else:
            out[key].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def test_port_writes_the_golden_file():
    text = cs.radical_text(TMatrix, ttrace.capture_logs, ttrace.log,
                           tfmt.cformat, Fraction)
    assert text == GOLDEN.read_text(encoding="utf-8")


def test_jax_package_writes_the_golden_file():
    """Every section the JAX package's way, but for the factored line of
    a real cubic root alone (its EX-domain quotient, not ported yet:
    ROADMAP.md queue 1 item 7) and, by design, P⁻¹ and D over ℚ(√-3)
    (quotients, equal in value above).  The geometric multiplicities of the irreducible
    cubic, where ``linsolve`` takes minutes, are sympy's rank."""
    golden = _sections(GOLDEN.read_text(encoding="utf-8"))
    seen = 0
    for name, rows, parts in cs.RADICAL_MATRICES:
        for part in parts:
            want = golden[(name, part)]
            if part == "geom" and name == "irreducible-cubic":
                box = []
                ttrace.capture_logs(lambda: box.append(
                    TMatrix(fraction_rows(rows))
                    .eigenvalues_with_geometric_multiplicities()))
                assert [g for _, g in box[0].values()] == [
                    _sympy_geometric(rows, e) for e in box[0]]
                seen += 1
                continue
            got = cs.radical_section(JMatrix, jtrace.capture_logs, jtrace.log,
                                     jfmt.cformat, sympy.Integer, rows, part)
            if (name, part) == ("irreducible-cubic", "real"):
                got = "\n".join(ln for ln in got.splitlines()
                                if not ln.startswith("Rozložený tvar:"))
            if (name, part) == ("complex-quadratic", "diag"):
                got, want = (t.split(r"\[ P^{-1}")[0] for t in (got, want))
            assert got == want, (name, part)
            seen += 1
    assert seen == sum(len(p) for _, _, p in cs.RADICAL_MATRICES)
