"""The port's exact factorization over ℤ (``exact.zfactor``, Zassenhaus in
the order of sympy's ``dup_zz_factor``) against sympy's ``factor_list``,
with no sympy in the port:

- the factorization modulo a prime (distinct- and equal-degree splits),
  whose product is the polynomial mod p and whose factors are irreducible;
- Hensel lifting: the lifted factors multiply to the polynomial mod pˡ;
- the irreducible factors of seeded products, of xⁿ ± 1 to n = 30 and of
  Swinnerton-Dyer polynomials (which split modulo every prime, so only
  the recombination proves them irreducible);
- ``radical_roots`` on a product with large coefficients, whose quintic
  factor gives no roots (sympy's partial set), and on irreducible
  polynomials of degree ≥ 5 with no formula (the empty set).
"""

import functools
import random

import pytest
import sympy

from linalg_solver_tpu.exact.polynomial import Polynomial as JPoly
from linalg_solver_tpu_torch.exact import radicals, zfactor
from linalg_solver_tpu_torch.utils import fmt as tfmt

X = sympy.symbols("x")


def _ints(p):
    return [int(c) for c in sympy.Poly(p, X).all_coeffs()]


@functools.lru_cache(maxsize=None)
def _swinnerton_dyer(k):
    primes = [2, 3, 5, 7][:k]
    return tuple(_ints(sympy.minimal_polynomial(
        sum(sympy.sqrt(p) for p in primes), X)))


def _sympy_factors(c):
    return sorted(_ints(f.as_expr()) for f, _ in
                  sympy.Poly(c, X).factor_list()[1])


def test_factorization_mod_p_is_a_product_of_irreducibles():
    f = list(_swinnerton_dyer(3))
    for p in (3, 5, 7, 11, 13):
        if not zfactor.squarefree_mod([x % p for x in f], p):
            continue
        factors = zfactor.factor_mod(f, p)
        prod = [1]
        for g in factors:
            assert g[0] == 1
            assert len(zfactor.factor_mod(g, p)) == 1      # irreducible
            prod = zfactor.mod_mul(prod, g, p)
        assert prod == zfactor.mod_monic([x % p for x in f], p)
        # a Swinnerton-Dyer polynomial splits into factors of degree ≤ 2
        assert max(len(g) - 1 for g in factors) <= 2


def test_hensel_lift_multiplies_to_the_polynomial():
    f = _ints((X ** 4 - 10 * X ** 2 + 1) * (3 * X ** 2 + X - 7))
    p, l = 11, 6
    modular = zfactor.factor_mod(f, p)
    lifted = zfactor.hensel_lift(p, f, modular, l)
    pl = p ** l
    prod = [f[0] % pl]
    for g in lifted:
        prod = zfactor.mod_mul(prod, g, pl)
    assert prod == [x % pl for x in f]


@pytest.mark.parametrize("kind", ["products", "binomials", "swinnerton"])
def test_zassenhaus_is_sympys_factor_list(kind):
    cases = []
    if kind == "products":
        rng = random.Random(5)
        for _ in range(80):
            p = sympy.Integer(1)
            for _ in range(rng.randint(1, 3)):
                p *= sympy.Poly([rng.randint(1, 4)] + [
                    rng.randint(-6, 6) for _ in range(rng.randint(1, 5))],
                    X).as_expr()
            cases.append(_ints(p))
    elif kind == "binomials":
        cases = [_ints(X ** n + s) for n in range(1, 31) for s in (1, -1)]
    else:
        cases = [list(_swinnerton_dyer(k)) for k in (2, 3)]
    for c in cases:
        sq = sympy.Poly(c, X).sqf_part()
        f = _ints(sq.primitive()[1].as_expr())
        if f[0] < 0:
            f = [-x for x in f]
        assert sorted(zfactor.factor_squarefree(f)) == _sympy_factors(f), c


def test_swinnerton_dyer_roots_match_jax():
    """x⁸ − 40x⁶ + 352x⁴ − 960x² + 576 (√2 + √3 + √5) is irreducible though
    it splits modulo every prime: ``_try_decompose`` writes its eight
    roots through the quasi-symmetric quartic of its outer component."""
    c = list(_swinnerton_dyer(3))
    deg = len(c) - 1
    powers = {deg - i: v for i, v in enumerate(c) if v}
    port = radicals.radical_roots(dict(powers))
    want = JPoly(dict(powers)).radical_roots()
    assert [(tfmt.cformat(r), m) for r, m in port.items()] == [
        (sympy.latex(r), m) for r, m in want.items()]
    assert tfmt.cformat(next(iter(port))) == (
        r"- \sqrt{- 2 \sqrt{6} - 2 \sqrt{5} \sqrt{5 - 2 \sqrt{6}} + 10}")


def test_large_coefficients_and_unsolvable_factors():
    """A cubic times a quintic with large coefficients: sympy's partial
    set, the cubic's roots (each with the cubic as its factor); λ⁵ − λ − 1
    and an irreducible sextic have none."""
    cubic = sympy.Poly([1000003, 0, -999983, 123457], X)
    quintic = sympy.Poly([7919, 0, 0, 0, -104729, -1299709], X)
    c = _ints((cubic * quintic).as_expr())
    deg = len(c) - 1
    got = radicals.radical_roots({deg - i: v for i, v in enumerate(c) if v})
    want = JPoly({deg - i: v for i, v in enumerate(c) if v}).radical_roots()
    assert [tfmt.cformat(r) for r in got] == [sympy.latex(r) for r in want]
    assert len(got) == 3 and all(
        r.minpoly == tuple(_ints(cubic.as_expr())) for r in got)
    for f in ([1, 0, 0, 0, -1, -1], [1, 0, 0, 0, 0, 1, 3]):
        assert zfactor.factor_squarefree(f) == [f]
        assert radicals.radical_roots({len(f) - 1 - i: v for i, v in
                                       enumerate(f) if v}) == {}
