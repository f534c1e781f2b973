"""Inputs shared by the port's exact-text tests: integer matrices built
once from a seeded ``random.Random``, handed to the JAX package as
``sympy.Rational`` and to the port as ``fractions.Fraction``.

The three determinant families are built as ``tests/test_golden_fuzz.py``
builds them (the same draws from the same seeds): random sparse patterns
(n ≤ 6, density 0.3–0.6, ``Random(626262)``), scrambled block-triangular
patterns (``Random(737373)``) and AddRow chains (``Random(848484)``)."""

import random
from fractions import Fraction

import sympy


def _rand_ints(rng, m, n, density=1.0, lo=-4, hi=4):
    return [[rng.randint(lo, hi) if rng.random() < density else 0
             for _ in range(n)] for _ in range(m)]


def fuzz_patterns(count=60):
    """``test_golden_fuzz``'s random sparse matrices, the first ``count``."""
    rng = random.Random(626262)
    out = []
    for _ in range(count):
        n = rng.choice([3, 4, 4, 5, 5, 6])
        density = rng.choice([0.3, 0.4, 0.5, 0.6])
        out.append(_rand_ints(rng, n, n, density))
    return out


def dm_patterns(count=24):
    """Scrambled 2–3-block triangular matrices."""
    rng = random.Random(737373)
    out = []
    for _ in range(count):
        sizes = rng.choice([[2, 2], [2, 3], [3, 2], [2, 2, 2]])
        n = sum(sizes)
        items = [[0] * n for _ in range(n)]
        o = 0
        for sz in sizes:
            for i in range(sz):
                for j in range(sz):
                    items[o + i][o + j] = rng.randint(-4, 4) or 1
            for i in range(o + sz, n):
                for j in range(o, o + sz):
                    if rng.random() < 0.4:
                        items[i][j] = rng.randint(-3, 3)
            o += sz
        rows, cols = list(range(n)), list(range(n))
        rng.shuffle(rows)
        rng.shuffle(cols)
        out.append([[items[rows[i]][cols[j]] for j in range(n)]
                    for i in range(n)])
    return out


def addrow_patterns(count=24):
    """Row pairs with shared sparsity, chained: the planner's AddRow."""
    rng = random.Random(848484)
    out = []
    for _ in range(count):
        n = rng.choice([4, 5, 5, 6])
        items = _rand_ints(rng, n, n, 0.5)
        for (i, j) in [(0, 1)] + ([(2, 3)] if n >= 4 else []):
            piv = rng.randrange(n)
            for c in range(n):
                if c == piv or items[j][c] != 0:
                    items[i][c] = rng.randint(1, 4)
                    if items[j][c] == 0:
                        items[j][c] = rng.randint(1, 4)
                else:
                    items[i][c] = 0
        out.append(items)
    return out


def chunks(seq, k):
    """``seq`` in ``k`` contiguous chunks (the parametrized cases)."""
    size = -(-len(seq) // k)
    return [seq[i:i + size] for i in range(0, len(seq), size)]


def pattern(items):
    return [[x != 0 for x in row] for row in items]


def to_sympy(x):
    """An int, a Fraction or a ``(p, q)`` pair as ``sympy.Rational``."""
    if isinstance(x, tuple):
        return sympy.Rational(*x)
    if isinstance(x, Fraction):
        return sympy.Rational(x.numerator, x.denominator)
    return sympy.Rational(x)


def to_fraction(x):
    """The same number as ``Fraction`` (a JAX value by its p and q)."""
    if isinstance(x, tuple):
        return Fraction(*x)
    if hasattr(x, "p") and hasattr(x, "q"):
        return Fraction(int(x.p), int(x.q))
    return Fraction(x)


def sympy_rows(items):
    return [[to_sympy(x) for x in row] for row in items]


def fraction_rows(items):
    return [[to_fraction(x) for x in row] for row in items]


def same_value(port_value, jax_value) -> bool:
    """Equal as fractions (a port int/Fraction against a sympy number)."""
    return to_fraction(port_value) == to_fraction(jax_value)
