"""The port's LaTeX layer (``linalg_solver_tpu_torch.utils.fmt`` and
``exact.polynomial``'s printer) against the JAX package's, which writes
scalars with ``sympy.latex``: ints, fractions (``Fraction`` to the port,
``sympy.Rational`` to the JAX package, built from the same integer
pairs), signs and the float forms (fixed, exponent, 15 significant
digits, inf, NaN), byte for byte; ``pretty_print_arithmetic``, the four
matrix builders and ``Polynomial.cformat`` under each ``arg_of``."""

import random
import struct
from fractions import Fraction

import pytest
import sympy

from linalg_solver_tpu.exact.polynomial import Polynomial as JPoly
from linalg_solver_tpu.utils import fmt as jfmt
from linalg_solver_tpu_torch.exact.polynomial import Polynomial as TPoly
from linalg_solver_tpu_torch.utils import fmt as tfmt


def _pairs(seed, count, lo=-40, hi=40):
    rng = random.Random(seed)
    return [(rng.randint(lo, hi), rng.choice([1, 1, 2, 3, 4, 6, 7, 12, 35]))
            for _ in range(count)]


def _both(pairs):
    """The same numbers for both packages."""
    return ([sympy.Rational(p, q) for p, q in pairs],
            [Fraction(p, q) for p, q in pairs])


FLOATS = [1 / 3, 2.0, -1.25e-7, 1e20, -0.0, 0.0, float("inf"), float("-inf"),
          float("nan"), 1e-5, 1e-4, 9.99999999999999e-5, 123456789012345.0,
          1234567890123456.0, 99999999999999.99, 1e15, 1e14, 0.1, -7.5,
          5e-324, 1.7976931348623157e308, 0.5, 2.5e-5]


def test_scalars_as_sympy_latex():
    js, ts = _both(_pairs(1, 400) + [(0, 1), (-12, 1), (-1, 2), (7, 3)])
    for j, t in zip(js, ts):
        assert tfmt.cformat(t) == jfmt.cformat(j), (t, j)
        for arg_of in ("+", "*", "^"):
            assert tfmt.cformat(t, arg_of) == jfmt.cformat(j, arg_of)
    for i in (0, 1, -1, -3, 17, 10**40, -10**40, True):
        assert tfmt.cformat(i) == jfmt.cformat(i)
    assert tfmt.cformat(Fraction(-1, 2)) == r"- \frac{1}{2}"


def test_floats_as_sympy_latex():
    rng = random.Random(2)
    vals = list(FLOATS)
    for _ in range(3000):
        vals.append(struct.unpack(
            "<d", struct.pack("<Q", rng.getrandbits(64)))[0])
        vals.append(rng.uniform(-10, 10) * 10.0 ** rng.randint(-8, 17))
        vals.append(rng.randint(-10**6, 10**6) / rng.choice([3, 7, 1024]))
    for x in vals:
        assert tfmt.cformat(x) == jfmt.cformat(x), repr(x)


@pytest.mark.parametrize("op", ["+", "-", "*"])
def test_pretty_print_arithmetic(op):
    pairs = _pairs(3, 120, -6, 6)
    js, ts = _both(pairs)
    for k in range(0, len(js) - 1):
        assert (tfmt.pretty_print_arithmetic(ts[k], op, ts[k + 1])
                == jfmt.pretty_print_arithmetic(js[k], op, js[k + 1]))
    with pytest.raises(ValueError):
        tfmt.pretty_print_arithmetic(1, "/", 2)


def test_matrix_builders():
    rng = random.Random(4)
    for m, n in ((1, 1), (1, 3), (3, 1), (3, 4), (4, 4)):
        js, ts = _both(_pairs(rng.randint(0, 10**6), m * n))
        jrows = [js[i * n:(i + 1) * n] for i in range(m)]
        trows = [ts[i * n:(i + 1) * n] for i in range(m)]
        assert tfmt.make_latex_matrix(trows) == jfmt.make_latex_matrix(jrows)
        assert (tfmt.make_latex_vector(ts) == jfmt.make_latex_vector(js))
        for bar in (None, 0, n - 1):
            assert (tfmt.make_latex_augmented_matrix(trows, bar)
                    == jfmt.make_latex_augmented_matrix(jrows, bar))
        header = " & ".join("x_{%d}" % (j + 1) for j in range(n))
        for rows_t, rows_j in ((trows, jrows), ([], [])):
            assert (tfmt.make_latex_vertical_augmented_matrix(
                header, rows_t, n)
                == jfmt.make_latex_vertical_augmented_matrix(
                    header, rows_j, n))


def test_nary_helpers():
    js, ts = _both(_pairs(5, 9))
    assert tfmt.multi_add(ts) == jfmt.multi_add(js)
    assert tfmt.multi_mul(ts) == jfmt.multi_mul(js)
    assert tfmt.multi_add_vargs(*ts) == jfmt.multi_add_vargs(*js)
    assert (tfmt.linear_comb(ts[:4], ts[4:8])
            == jfmt.linear_comb(js[:4], js[4:8]))
    assert tfmt.pcformat(r"%s + %s", ts[0], "x") == jfmt.pcformat(
        r"%s + %s", js[0], "x")


@pytest.mark.parametrize("arg_of", [None, "+", "*", "^"])
def test_polynomial_cformat(arg_of):
    rng = random.Random(6)
    for _ in range(60):
        degs = rng.sample(range(5), rng.randint(0, 4))
        pairs = [(rng.choice([-3, -2, -1, 1, 2, 5]), rng.choice([1, 1, 2, 3]))
                 for _ in degs]
        js, ts = _both(pairs)
        var = rng.choice(["x", r"\lambda"])
        jp = JPoly(dict(zip(degs, js)), var)
        tp = TPoly(dict(zip(degs, ts)), var)
        assert tp.cformat(arg_of) == jp.cformat(arg_of)
        assert tfmt.cformat(tp, arg_of) == jfmt.cformat(jp, arg_of)


def test_polynomial_arithmetic_and_division():
    """Ring arithmetic, evaluation and exact division by (x − r) against
    the JAX package's (sympy's ``div``), and the remainder raising."""
    rng = random.Random(7)
    for _ in range(40):
        roots = [Fraction(rng.randint(-4, 4), rng.choice([1, 2, 3]))
                 for _ in range(rng.randint(1, 3))]
        lead = Fraction(rng.randint(1, 5))
        tp = TPoly({0: lead})
        for r in roots:
            tp = tp * TPoly({0: -r, 1: 1})
        jp = JPoly({e: sympy.Rational(c.numerator, c.denominator)
                    for e, c in tp.powers.items()})
        assert (tp + tp * 2 - 1).cformat() == (jp + jp * 2 - 1).cformat()
        x = Fraction(rng.randint(-9, 9), 4)
        assert tp(x) == jp(sympy.Rational(x.numerator, x.denominator))
        r = roots[0]
        tq = tp.remove_root(r)
        jq = jp.remove_root(sympy.Rational(r.numerator, r.denominator))
        assert tq.cformat() == jq.cformat()
        assert tq == TPoly({e: Fraction(int(c.p), int(c.q))
                            for e, c in jq.powers.items()})
        assert tq * TPoly({0: -r, 1: 1}) == tp
        miss = max(roots) + 1
        with pytest.raises(ValueError):
            tp.remove_root(miss)
    # roots in radicals: rational and quadratic ones since the eigen slice,
    # an irreducible cubic still not (tests/test_torch_eigen_exact.py
    # holds them against sympy)
    assert TPoly({1: 1}).radical_roots() == {0: 1}
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        TPoly({3: 1, 1: 1, 0: 1}).radical_roots()
