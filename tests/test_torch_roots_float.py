"""The port's roots of float-coefficient polynomials against the JAX
package's ``Polynomial.radical_roots`` (``sympy.roots`` on RR, that is
``Poly.nroots``: mpmath's Durand–Kerner at 53 + 10·deg bits), with no
sympy or mpmath in the port:

- the binary arithmetic of ``exact.nroots`` (``mpc`` products, quotients
  with their truncated intermediate sums, moduli) bit for bit against
  mpmath's ``libmpc`` on random operands;
- the roots of seeded float polynomials of degree 2–6, a double root (its
  two roots split as mpmath splits them) and equal roots merged: the same
  dict order and multiplicities, ``sympy.latex`` of every root and its
  negation, ``is_real``, and each value equal to sympy's;
- the factored line of the JAX package's ``factor_roots`` on such roots
  (``sympy.div`` over RR and CC): written where every division is exact,
  ``ValueError`` where one leaves a remainder;
- ``sympy.cancel``'s AddRow quotient over RR (``Float`` coefficients,
  which never equal an int) and the whole ``eigenvalues()`` text of the
  three float-coefficient matrices among the first eight of
  ``tools/census_eigen.py``'s 4×4 census, both ``real_only`` settings,
  byte for byte;
- the AddRow limit both packages share: a quotient that is not a
  polynomial raises in each (ROADMAP.md §3).
"""

import random

import pytest
import sympy
from mpmath import libmp

from linalg_solver_tpu.exact.matrix import Matrix as JMatrix
from linalg_solver_tpu.exact.polynomial import Polynomial as JPoly
from linalg_solver_tpu.utils import fmt as jfmt
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch.exact import Matrix as TMatrix
from linalg_solver_tpu_torch.exact import nroots as nr
from linalg_solver_tpu_torch.exact.polynomial import Polynomial as TPoly
from linalg_solver_tpu_torch.utils import fmt as tfmt
from linalg_solver_tpu_torch.utils import trace as ttrace

#: the first eight 4×4 matrices of the census whose characteristic
#: polynomial has float coefficients
FLOAT_MATRICES = [
    [[1, 1, -5, -1], [3, 2, 1, -1], [2, 0, 4, -2], [3, -3, -1, -3]],
    [[-4, 4, -1, 3], [4, -3, -1, -4], [-4, 5, 0, 2], [3, -4, 0, 1]],
    [[0, 3, 2, -4], [-1, 3, -1, -4], [3, 0, 3, -2], [4, 3, 4, -1]],
]
ADDROW_LIMIT = [[-1, -1, 3, 3], [3, 0, 0, -2], [1, -3, -5, 3], [-3, 5, 4, 1]]


@pytest.fixture(autouse=True)
def python_engine(monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")


def _mpf(a):
    sign, man, exp, _ = a
    return (-man if sign else man, exp) if man else nr.ZERO


def test_mpc_arithmetic_is_mpmaths_bit_for_bit():
    rng = random.Random(3)
    ops = [("div", libmp.mpc_div, nr.c_div), ("mul", libmp.mpc_mul, nr.c_mul),
           ("add", libmp.mpc_add, nr.c_add), ("sub", libmp.mpc_sub, nr.c_sub)]
    for _ in range(3000):
        prec = rng.choice([53, 63, 93, 113])
        v = [libmp.from_man_exp(rng.getrandbits(rng.randint(1, 120))
                                * rng.choice([1, -1]), rng.randint(-200, 10))
             for _ in range(4)]
        z, w = (v[0], v[1]), (v[2], v[3])
        zz, ww = (_mpf(v[0]), _mpf(v[1])), (_mpf(v[2]), _mpf(v[3]))
        for _, theirs, ours in ops:
            try:
                want = theirs(z, w, prec, "n")
            except ZeroDivisionError:
                continue
            assert ours(zz, ww, prec) == (_mpf(want[0]), _mpf(want[1]))
        assert nr.c_abs(zz, prec) == _mpf(libmp.mpc_abs(z, prec, "n"))


def _check(coeffs):
    deg = len(coeffs) - 1
    powers = {deg - i: c for i, c in enumerate(coeffs) if c}
    port = TPoly(dict(powers)).radical_roots()
    want = JPoly(dict(powers)).radical_roots()
    assert len(port) == len(want)
    for (rp, mp), (rs, ms) in zip(port.items(), want.items()):
        assert mp == ms
        assert tfmt.cformat(rp) == jfmt.cformat(rs)
        assert tfmt.cformat(-rp) == jfmt.cformat(-rs)
        assert (getattr(rp, "is_real", True) is True) == (rs.is_real is True)
        assert complex(rp) == complex(rs)
    return port


@pytest.mark.parametrize("cases", [
    [([1, 0, -3.0, 2.0], ["-2.0", "1.0"]),                # merged double root
     ([1, 2.0, 1], None),                                 # split double root
     ([1, 0, 2.0, 0, 1], None)],                          # two double roots
    [([1.0, -4.0, -2.0, 4.0, 112.0], None),
     ([2.5, 1, -7.000000000000001, 3, 1], None),
     ([1, 0, 4.0], [r"- 2.0 i", r"2.0 i"]),
     ([1, -1.5, 0, 0], ["1.5", "0"])],                    # zero roots last
])
def test_float_roots_match_jax(cases):
    for coeffs, want in cases:
        port = _check(coeffs)
        if want is not None:
            assert [tfmt.cformat(r) for r in port] == want


def test_seeded_float_polynomials_match_jax():
    rng = random.Random(2026)
    for _ in range(60):
        deg = rng.randint(2, 6)
        c = [rng.choice([1, 1.0, -1.0, 2.0, round(rng.uniform(-5, 5), 3)])]
        c += [rng.choice([float(rng.randint(-9, 9)), round(rng.uniform(-9, 9),
                                                           2),
                          rng.randint(-9, 9) / 3]) for _ in range(deg)]
        c[-1] = c[-1] or 1.0
        _check(c)


@pytest.mark.parametrize("group", [
    [{3: 1, 1: -3.0, 0: 2.0},           # exact divisions: 1.0 · (λ+2.0)…
     {3: -1.0, 1: 3.0, 0: -2.0}],
    [{2: 1, 0: 4.0},                    # complex roots, exact over CC
     {3: 2, 2: 1.0, 1: -1},             # a zero root
     {4: 1.0, 3: -4.0, 2: -2.0, 1: 4.0, 0: 112.0}],  # inexact: ValueError
])
def test_float_factored_line_matches_jax(group):
    for powers in group:
        _factored_line_matches_jax(powers)


def _factored_line_matches_jax(powers):
    jp, tp = JPoly(dict(powers), r"\lambda"), TPoly(dict(powers), r"\lambda")
    jroots, troots = jp.radical_roots(), tp.radical_roots()
    for real in (False, True):
        jr = [(r, m) for r, m in jroots.items()
              if not real or getattr(r, "is_real", None) is True]
        tr = [(r, m) for r, m in troots.items()
              if not real or getattr(r, "is_real", True)]
        try:
            want = jp.factor_roots(jr)
        except ValueError:
            with pytest.raises(ValueError):
                tp.factor_roots(tr)
            continue
        got = tp.factor_roots(tr)
        render = [(jfmt.cformat(f, arg_of="*"), m) for f, m in want.items()]
        assert [(tfmt.cformat(f, arg_of="*"), m)
                for f, m in got.items()] == render


def test_addrow_quotient_over_rr_is_sympys_cancel():
    """Both packages' determinant text of every float-coefficient matrix
    among the first 24 of the census (a non-fraction-free AddRow with int
    entries), and the ``Float`` semantics the text rests on."""
    rng = random.Random(0)
    mats = [[[rng.randint(-5, 5) for _ in range(4)] for _ in range(4)]
            for _ in range(24)]
    seen = limits = 0
    for rows in mats:
        boxes = []
        texts = []
        for M, P, tr in ((JMatrix, JPoly, jtrace), (TMatrix, TPoly, ttrace)):
            lam = P({1: 1}, var=r"\lambda")
            try:
                texts.append(tr.capture_logs(lambda: boxes.append(
                    (M(rows) - M.diagonal([lam] * 4)).determinant(
                        log_permutation_details=True))))
            except ValueError:
                # the AddRow limit: the JAX package's quotient is no
                # polynomial
                assert tr is ttrace and not isinstance(boxes[0], JPoly)
                limits += 1
                break
        else:
            assert texts[1] == texts[0]
            if not all(isinstance(c, int) or hasattr(c, "denominator")
                       for c in boxes[1].powers.values()):
                seen += 1
    assert seen >= 3 and limits >= 1
    one = nr.Float(1.0)
    assert one != 1 and one == 1.0 and (one * 2) == nr.Float(2.0)
    assert isinstance(one * 3, nr.Float) and one - 1.0 == 0 and \
        type(one - 1.0) is int


@pytest.mark.parametrize("index", range(len(FLOAT_MATRICES)))
def test_float_matrix_eigenvalues_text_byte_for_byte(index):
    rows = FLOAT_MATRICES[index]
    for real in (False, True):
        jtext = jtrace.capture_logs(
            lambda: JMatrix(rows).eigenvalues(real_only=real))
        ttext = ttrace.capture_logs(
            lambda: TMatrix(rows).eigenvalues(real_only=real))
        assert ttext == jtext


def test_addrow_limit_raises_in_both_packages():
    """The quotient of the last AddRow is a rational function: the JAX
    package's ``sympy.cancel`` leaves it so and ``radical_roots`` fails on
    the product, the port's division raises ``ValueError``."""
    with pytest.raises(AttributeError, match="radical_roots"):
        jtrace.capture_logs(lambda: JMatrix(ADDROW_LIMIT).eigenvalues())
    with pytest.raises(ValueError, match="AddRow"):
        ttrace.capture_logs(lambda: TMatrix(ADDROW_LIMIT).eigenvalues())
