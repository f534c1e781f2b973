"""``tests/data_torch/eigen_roots.tex`` (``chip_smoke.py`` phase 79): the
``eigenvalues()`` and ``eigenvalues(real_only=True)`` text of
``chip_smoke.ROOT_MATRICES`` — float-coefficient characteristic
polynomials, Ferrari's quartics, decompositions, cyclotomic polynomials,
binomials and a product that Zassenhaus splits:

- the port writes it byte for byte, and ``chip_smoke.drive_roots`` does
  so with sympy, mpmath and jax refused;
- the JAX package writes every section byte for byte, but for the
  factored lines of Ferrari's quartics, which its ``remove_root`` takes
  minutes over (and for ``real_only``, the quotient by a lone radical root
  that the port does not write: ROADMAP.md queue 1 item 7): there the
  rest of its text is held to the file with its factored line left out,
  and the port's factored line is held to the characteristic polynomial
  at 40 digits;
- where Ferrari's formula takes the cube root of a complex or negative
  number, sympy orders and branches the terms of each root by the
  rounding noise of its ``evalf``, which the port does not emulate
  (ROADMAP.md queue 1 item 7): there the roots line alone is held in
  value, the roots that ``eigenvalues`` returns being the JAX package's
  one to one, with the same multiplicities and ``is_real``
  (``sweep_radicals.roots_differ``), so the same set under
  ``real_only``.
"""

import pathlib
import sys
from fractions import Fraction

import pytest
import sympy

import chip_smoke as cs
from linalg_solver_tpu.exact import polynomial as jpolynomial
from linalg_solver_tpu.exact.matrix import Matrix as JMatrix
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch.exact import Matrix as TMatrix
from linalg_solver_tpu_torch.utils import trace as ttrace
from tools.census_eigen import FACTORED, ROOTS, char_poly, factored_right
from tools.sweep_radicals import roots_differ, sympy_values

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / cs.ROOTS_GOLDEN
#: the matrices whose factored line the JAX package takes minutes over
SLOW = {"ferrari-x4-x-1", "ferrari-complex-x4+x+1",
        "ferrari-negative-x4-3x3-x2+3x-1"}
#: the matrices whose roots sympy orders and branches by evalf's noise
NOISE = {"ferrari-complex-x4+x+1", "ferrari-negative-x4-3x3-x2+3x-1"}


@pytest.fixture(autouse=True)
def python_engine(monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")


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
    text = cs.roots_text(TMatrix, ttrace.capture_logs, Fraction)
    assert text == GOLDEN.read_text(encoding="utf-8")


def test_phase_79_refuses_sympy_mpmath_and_jax():
    assert cs.drive_roots() > 0
    finder = cs._Refused(("sympy", "mpmath"))
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] == "mpmath"}
    sys.meta_path.insert(0, finder)
    try:
        with pytest.raises(ImportError, match="refused"):
            import mpmath  # noqa: F401
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)
    assert "sympy" in sys.modules and "mpmath" in sys.modules


def _port_factored_line_is_right(rows):
    """The port's factored form of the characteristic polynomial
    multiplies out to it at 40 digits at three points."""
    poly = char_poly([[Fraction(x) for x in r] for r in rows])
    assert factored_right(poly, poly.radical_roots())


def _jax_eigenvalues(rows, conv, real_only, leave_out_factored):
    """The JAX package's text and roots, its factored line left out on
    request (``factor_roots`` refused)."""
    def refuse(self, roots):
        raise ValueError("left out")
    box = []
    with pytest.MonkeyPatch.context() as m:
        if leave_out_factored:
            m.setattr(jpolynomial.Polynomial, "factor_roots", refuse)
        text = jtrace.capture_logs(lambda: box.append(JMatrix(
            [[conv(x) for x in r] for r in rows]).eigenvalues(
                real_only=real_only)))
    return text.rstrip("\n"), box[0]


@pytest.mark.parametrize("chunk", [0, 1, 2])
def test_jax_package_writes_the_golden_file(chunk):
    golden = _sections(GOLDEN.read_text(encoding="utf-8"))
    for name, rows, exact in cs.ROOT_MATRICES[chunk::3]:
        conv = sympy.Rational if exact else int
        for part in ("eig", "real"):
            want = golden[(name, part)]
            got, roots = _jax_eigenvalues(rows, conv, part == "real",
                                          name in SLOW)
            if name in SLOW:
                want = "\n".join(ln for ln in want.splitlines()
                                 if FACTORED not in ln)
                _port_factored_line_is_right(rows)
            if name in NOISE:
                port = []
                ttrace.capture_logs(lambda: port.append(TMatrix(
                    [[Fraction(x) for x in r] for r in rows]).eigenvalues(
                        real_only=part == "real")))
                msg = roots_differ(port[0], sympy_values(roots))
                assert msg is None, (name, part, msg)
                got, want = ["\n".join(ln for ln in t.splitlines()
                                       if ROOTS not in ln)
                             for t in (got, want)]
            assert got == want, (name, part)
