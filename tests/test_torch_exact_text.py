"""The port's exact path (``linalg_solver_tpu_torch.exact``) against the
JAX package's: each input built once from a seed, ``sympy.Rational`` to
the JAX package and ``Fraction`` to the port, the ``capture_logs`` text
equal byte for byte and the values equal as fractions.

- the planned determinant (Python engine on both sides) on the planner
  test's 60 random sparse patterns, 24 scrambled block-triangular and 24
  AddRow-chain patterns (``tests/test_golden_fuzz.py``'s draws), and on
  characteristic-style matrices with ``Polynomial`` diagonals (the
  fraction-free AddRow and its exact division);
- the legacy determinant and ``direct_determinant`` with and without
  ``log_permutation_details``;
- ``find_preimage_of`` logged and quiet on regular, inconsistent and
  rank-deficient systems (one with 11 free variables: the generators in
  the JAX package's ``tau0, tau1, tau10, tau2, …`` order);
- ``kernel``, ``inverse`` logged and quiet (singular included), ``rank``.
"""

import random
from fractions import Fraction

import pytest
import sympy

from linalg_solver_tpu.exact.matrix import Matrix as JMatrix
from linalg_solver_tpu.exact.matrix import NoSolution as JNoSolution
from linalg_solver_tpu.exact.polynomial import Polynomial as JPoly
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch.exact import Matrix as TMatrix
from linalg_solver_tpu_torch.exact import NoSolution as TNoSolution
from linalg_solver_tpu_torch.exact import Polynomial as TPoly
from linalg_solver_tpu_torch.exact import from_reference_items
from linalg_solver_tpu_torch.utils import trace as ttrace
from linalg_solver_tpu_torch.utils.fmt import cformat

from torch_text_cases import addrow_patterns, chunks, dm_patterns
from torch_text_cases import fraction_rows, fuzz_patterns, same_value
from torch_text_cases import sympy_rows, to_fraction, to_sympy


def _run(run_jax, run_port):
    """Both sides under their own ``capture_logs``: the texts must be
    equal byte for byte; returns the two results."""
    jbox, tbox = [], []
    jtext = jtrace.capture_logs(lambda: jbox.append(run_jax()))
    ttext = ttrace.capture_logs(lambda: tbox.append(run_port()))
    assert ttext == jtext
    return jbox[0], tbox[0]


def _det_case(items, **kw):
    j, t = _run(lambda: JMatrix(sympy_rows(items)).determinant(**kw),
                lambda: TMatrix(fraction_rows(items)).determinant(**kw))
    assert same_value(t, j), (items, t, j)


DET_CASES = fuzz_patterns(60)
DET_CHUNKS = chunks(DET_CASES, 4)
STRUCTURED = dm_patterns(24) + addrow_patterns(24)


@pytest.mark.parametrize("chunk", range(len(DET_CHUNKS)))
def test_planned_determinant_random_sparse(chunk, monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    for items in DET_CHUNKS[chunk]:
        _det_case(items, log_permutation_details=True)


@pytest.mark.parametrize("chunk", range(2))
def test_planned_determinant_dm_and_addrow(chunk, monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    for items in chunks(STRUCTURED, 2)[chunk]:
        _det_case(items)


def test_planned_determinant_polynomial_entries(monkeypatch):
    """Entries ``a − λ`` on the diagonal and a shared-sparsity row pair:
    the fraction-free AddRow derivation and its exact division (sympy's
    ``cancel`` in the JAX package, long division in the port)."""
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    rng = random.Random(959595)
    for _ in range(10):
        n = rng.choice([3, 4, 4])
        ints = [[rng.randint(-3, 3) if rng.random() < 0.5 else 0
                 for _ in range(n)] for _ in range(n)]
        for c in range(2, n):
            ints[0][c], ints[1][c] = rng.randint(1, 3), rng.randint(1, 3)
        lam = r"\lambda"

        def rows(to_num, poly):
            return [[poly({0: to_num(ints[i][j]), 1: to_num(-1)}, lam)
                     if i == j else to_num(ints[i][j]) for j in range(n)]
                    for i in range(n)]

        j, t = _run(
            lambda: JMatrix(rows(sympy.Integer, JPoly)).determinant(),
            lambda: TMatrix(rows(Fraction, TPoly)).determinant())
        assert isinstance(t, TPoly) and isinstance(j, JPoly)
        assert t.powers == {e: to_fraction(c) for e, c in j.powers.items()}


def test_legacy_determinant():
    rng = random.Random(5150)
    for trial in range(36):
        n = rng.randint(2, 5)
        kind = trial % 3
        items = [[rng.randint(-4, 4) for _ in range(n)] for _ in range(n)]
        if kind == 0:
            for i in range(n):
                for j in range(i):
                    items[i][j] = 0
        elif kind == 1:
            for i in range(n):
                for j in range(i + 1, n):
                    items[i][j] = 0
        else:
            r, keep = rng.randrange(n), rng.randrange(n)
            for j in range(n):
                if j != keep:
                    items[r][j] = 0
            items[r][keep] = rng.randint(1, 4)
        _det_case(items, use_optimal=False)


@pytest.mark.parametrize("details", [False, True])
def test_direct_determinant(details):
    rng = random.Random(8086 + details)
    for _ in range(18):
        n = rng.randint(2, 4)
        density = rng.choice([0.7, 1.0])
        items = [[rng.randint(-4, 4) if rng.random() < density else 0
                  for _ in range(n)] for _ in range(n)]
        j, t = _run(
            lambda: JMatrix(sympy_rows(items)).direct_determinant(details),
            lambda: TMatrix(fraction_rows(items)).direct_determinant(details))
        assert same_value(t, j)


def _same_solution(t, j):
    """An AffineSubspace or NoSolution of each package, equal as
    fractions, the generators in the same order."""
    if isinstance(j, JNoSolution):
        assert isinstance(t, TNoSolution)
        return
    assert [to_fraction(x) for x in t.vec] == [to_fraction(x) for x in j.vec]
    if j.generators is None:
        assert t.generators is None
        return
    assert (t.generators.rows, t.generators.cols) == (
        j.generators.rows, j.generators.cols)
    assert ([[to_fraction(x) for x in r] for r in t.generators.items]
            == [[to_fraction(x) for x in r] for r in j.generators.items])


def _systems():
    """(A, b) pairs: regular, rank-deficient consistent, inconsistent,
    wide, tall, and a 2×12 of rank 1 (11 free variables)."""
    rng = random.Random(4242)
    out = []
    for _ in range(6):                      # regular
        n = rng.randint(2, 5)
        a = [[rng.randint(-5, 5) for _ in range(n)] for _ in range(n)]
        out.append((a, [rng.randint(-5, 5) for _ in range(n)]))
    for _ in range(6):                      # rank-deficient
        m, n = rng.randint(2, 4), rng.randint(3, 6)
        base = [[rng.randint(-3, 3) for _ in range(n)] for _ in range(2)]
        a = [[sum(rng.randint(-2, 2) * base[k][c] for k in range(2))
              for c in range(n)] for _ in range(m)]
        x = [rng.randint(-3, 3) for _ in range(n)]
        b = [sum(a[i][c] * x[c] for c in range(n)) for i in range(m)]
        out.append((a, b))                  # consistent
        out.append((a, [v + (i == 0) for i, v in enumerate(b)]))
    row = [rng.randint(1, 4) * rng.choice([-1, 1]) for _ in range(12)]
    out.append(([row, [2 * v for v in row]], [3, 6]))
    out.append(([[(1, 2), (2, 3)], [(3, 4), (-1, 5)]], [(1, 7), 2]))
    return out


@pytest.mark.parametrize("logged", [False, True])
def test_find_preimage(logged):
    kw = dict(log_matrices=logged, log_steps=logged, log_result=logged)
    for a, b in _systems():
        j, t = _run(
            lambda: JMatrix(sympy_rows(a)).find_preimage_of(
                [to_sympy(x) for x in b], **kw),
            lambda: TMatrix(fraction_rows(a)).find_preimage_of(
                [to_fraction(x) for x in b], **kw))
        _same_solution(t, j)


def test_eleven_free_variables_order():
    """sympy's parameters past ten sort as strings: the quiet path's
    generators come tau0, tau1, tau10, tau2, … — unlike the logged
    path's column order."""
    row = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]
    a, b = [row, [2 * v for v in row]], [3, 6]
    quiet = TMatrix(fraction_rows(a)).find_preimage_of(fraction_rows([b])[0])
    box = []
    ttrace.capture_logs(lambda: box.append(TMatrix(
        fraction_rows(a)).find_preimage_of(fraction_rows([b])[0],
                                           log_result=True)))
    logged = box[0]
    order = [0, 1, 10] + list(range(2, 10))
    assert quiet.generators.transpose().items == [
        logged.generators.transpose().items[k] for k in order]


def test_kernel_inverse_rank():
    rng = random.Random(777)
    cases = []
    for _ in range(8):
        n = rng.randint(2, 4)
        cases.append([[rng.randint(-4, 4) for _ in range(n)]
                      for _ in range(n)])
    sing = [[1, 2, 3], [2, 4, 6], [1, 0, 1]]
    cases += [sing, [[0, 0], [0, 0]], [[(1, 2), 1], [3, (2, 3)]]]
    for items in cases:
        j, t = _run(lambda: JMatrix(sympy_rows(items)).kernel(),
                    lambda: TMatrix(fraction_rows(items)).kernel())
        _same_solution(t, j)
        for logged in (False, True):
            kw = dict(log_matrices=logged, log_steps=logged,
                      log_result=logged)
            j, t = _run(lambda: JMatrix(sympy_rows(items)).inverse(**kw),
                        lambda: TMatrix(fraction_rows(items)).inverse(**kw))
            if isinstance(j, JNoSolution):
                assert isinstance(t, TNoSolution)
            else:
                assert ([[to_fraction(x) for x in r] for r in t.items]
                        == [[to_fraction(x) for x in r] for r in j.items])
        assert (TMatrix(fraction_rows(items)).rank()
                == JMatrix(sympy_rows(items)).rank())
    wide = [[1, 2, 3, 4], [2, 4, 6, 8], [0, 1, 0, 1]]
    assert TMatrix(fraction_rows(wide)).rank() == JMatrix(
        sympy_rows(wide)).rank() == 2


def test_from_reference_items_and_eigen_raise():
    import numpy as np

    rows = from_reference_items([[np.int64(3), (1, 2)], [Fraction(5, 1), -2]])
    assert rows == [[Fraction(3), Fraction(1, 2)], [Fraction(5), Fraction(-2)]]
    assert all(isinstance(x, Fraction) for r in rows for x in r)
    with pytest.raises(TypeError):
        from_reference_items([[0.5]])
    # λ² − λ − 17/2: the eigenvalues (1 ± √35)/2 are found since the eigen
    # slice, but an eigenspace over Q(√35) is not ported
    m = TMatrix(rows)
    roots = []
    ttrace.capture_logs(lambda: roots.extend(m.eigenvalues()))
    assert [cformat(r) for r in roots] == [
        r"\frac{1}{2} - \frac{\sqrt{35}}{2}",
        r"\frac{1}{2} + \frac{\sqrt{35}}{2}"]
    assert m.simplify() is m
    assert m.find_eigenspace(1).dim() == 0
    for call in (m.diagonalize, m.eigenvalues_with_geometric_multiplicities,
                 lambda: m.find_eigenspace(roots[0])):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            ttrace.capture_logs(call)
