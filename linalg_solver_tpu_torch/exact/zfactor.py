"""Exact factorization of integer polynomials over ℤ (Zassenhaus), in the
order of sympy's ``dup_zz_factor``: the squarefree part, a factorization
modulo a prime (distinct-degree split, then Cantor–Zassenhaus'
equal-degree split), Hensel lifting to a power of that prime past the
Mignotte bound, and the recombination of the lifted factors by subsets of
growing size.  Polynomials are lists of ints, highest degree first; the
zero polynomial mod p is ``[]``.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import List, Optional, Tuple

Poly = List[int]


# ---------------------------------------------------------------------------
# Arithmetic modulo p
# ---------------------------------------------------------------------------

def _trim(a: Poly) -> Poly:
    i = 0
    while i < len(a) and a[i] == 0:
        i += 1
    return a[i:]


def mod_divmod(a: Poly, b: Poly, p: int) -> Tuple[Poly, Poly]:
    """Long division mod p (b's leading coefficient a unit)."""
    a, inv, q = list(a), pow(b[0], -1, p), []
    while len(a) >= len(b):
        c = a[0] * inv % p
        q.append(c)
        for i, x in enumerate(b):
            a[i] = (a[i] - c * x) % p
        a.pop(0)
    return q, _trim(a)


def mod_mul(a: Poly, b: Poly, p: int) -> Poly:
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x:
            for j, y in enumerate(b):
                out[i + j] = (out[i + j] + x * y) % p
    return _trim(out)


def mod_add(a: Poly, b: Poly, p: int) -> Poly:
    n = max(len(a), len(b))
    a, b = [0] * (n - len(a)) + list(a), [0] * (n - len(b)) + list(b)
    return _trim([(x + y) % p for x, y in zip(a, b)])


def mod_sub(a: Poly, b: Poly, p: int) -> Poly:
    return mod_add(a, [-x for x in b], p)


def mod_gcd(a: Poly, b: Poly, p: int) -> Poly:
    """The monic gcd mod p."""
    while b:
        a, b = b, mod_divmod(a, b, p)[1]
    return mod_monic(a, p)


def mod_monic(a: Poly, p: int) -> Poly:
    if not a:
        return a
    inv = pow(a[0], -1, p)
    return [x * inv % p for x in a]


def mod_powmod(base: Poly, e: int, f: Poly, p: int) -> Poly:
    """base^e mod (f, p)."""
    out, base = [1], mod_divmod(base, f, p)[1]
    while e:
        if e & 1:
            out = mod_divmod(mod_mul(out, base, p), f, p)[1]
        base = mod_divmod(mod_mul(base, base, p), f, p)[1]
        e >>= 1
    return out


def _mod_gcdex(a: Poly, b: Poly, p: int) -> Tuple[Poly, Poly]:
    """(s, t) with s·a + t·b ≡ 1 mod p, for coprime a, b."""
    r0, r1, s0, s1, t0, t1 = a, b, [1], [], [], [1]
    while r1:
        q, r = mod_divmod(r0, r1, p)
        r0, r1 = r1, r
        s0, s1 = s1, mod_sub(s0, mod_mul(q, s1, p), p)
        t0, t1 = t1, mod_sub(t0, mod_mul(q, t1, p), p)
    inv = pow(r0[0], -1, p)
    return [x * inv % p for x in s0], [x * inv % p for x in t0]


def squarefree_mod(f: Poly, p: int) -> bool:
    n = len(f) - 1
    deriv = _trim([x * (n - i) % p for i, x in enumerate(f[:-1])])
    return bool(deriv) and len(mod_gcd(f, deriv, p)) == 1


# ---------------------------------------------------------------------------
# Factorization modulo p
# ---------------------------------------------------------------------------

def distinct_degree(f: Poly, p: int) -> List[Tuple[Poly, int]]:
    """[(g_d, d)]: g_d the product of f's irreducible factors of degree d
    mod p (f monic and squarefree mod p); the product of the factors of
    degree d is gcd(f, x^(p^d) − x)."""
    out, h, d = [], [1, 0], 0
    while len(f) - 1 >= 2 * (d + 1):
        d += 1
        h = mod_powmod(h, p, f, p)
        g = mod_gcd(f, mod_sub(h, [1, 0], p), p)
        if len(g) > 1:
            out.append((g, d))
            f = mod_divmod(f, g, p)[0]
            h = mod_divmod(h, f, p)[1]
    if len(f) > 1:
        out.append((f, len(f) - 1))
    return out


def equal_degree(f: Poly, d: int, p: int, rng: random.Random) -> List[Poly]:
    """Cantor–Zassenhaus: the monic irreducible factors of degree d of f
    (monic, squarefree, a product of such factors) mod an odd prime p."""
    if len(f) - 1 == d:
        return [f]
    while True:
        a = _trim([rng.randrange(p) for _ in range(len(f) - 1)])
        if len(a) < 2:
            continue
        b = mod_powmod(a, (p ** d - 1) // 2, f, p)
        g = mod_gcd(f, mod_sub(b, [1], p), p)
        if 1 < len(g) < len(f):
            return (equal_degree(g, d, p, rng)
                    + equal_degree(mod_divmod(f, g, p)[0], d, p, rng))


def factor_mod(f: Poly, p: int) -> List[Poly]:
    """The monic irreducible factors of f mod p (f squarefree mod p)."""
    rng = random.Random(p)
    f = mod_monic([x % p for x in f], p)
    out: List[Poly] = []
    for g, d in distinct_degree(f, p):
        out += equal_degree(g, d, p, rng)
    return out


# ---------------------------------------------------------------------------
# Hensel lifting (sympy's dup_zz_hensel_step / dup_zz_hensel_lift)
# ---------------------------------------------------------------------------

def _sym(a: Poly, m: int) -> Poly:
    """Coefficients reduced to the symmetric range (−m/2, m/2]."""
    return [x % m - m if x % m > m // 2 else x % m for x in a]


def _hensel_step(m: int, f: Poly, g: Poly, h: Poly, s: Poly, t: Poly
                 ) -> Tuple[Poly, Poly, Poly, Poly]:
    """From f ≡ g·h and s·g + t·h ≡ 1 mod m to the same mod m²."""
    M = m * m
    e = mod_sub(f, mod_mul(g, h, M), M)
    q, r = mod_divmod(mod_mul(s, e, M), h, M)
    u = mod_add(mod_mul(t, e, M), mod_mul(q, g, M), M)
    G = mod_add(g, u, M)
    H = mod_add(h, r, M)
    u = mod_sub(mod_add(mod_mul(s, G, M), mod_mul(t, H, M), M), [1], M)
    c, d = mod_divmod(mod_mul(s, u, M), H, M)
    b = mod_add(mod_mul(t, u, M), mod_mul(c, G, M), M)
    S = mod_sub(s, d, M)
    T = mod_sub(t, b, M)
    return G, H, S, T


def hensel_lift(p: int, f: Poly, factors: List[Poly], l: int) -> List[Poly]:
    """The monic factors mod p of f (its leading coefficient a unit mod p)
    lifted to monic factors mod p^l whose product is f/lc(f) mod p^l."""
    r = len(factors)
    lc = f[0]
    if r == 1:
        return [mod_monic(f, p ** l)]
    k = r // 2
    d = math.ceil(math.log2(l)) if l > 1 else 0
    g = [lc % p]
    for fi in factors[:k]:
        g = mod_mul(g, fi, p)
    h = [1]
    for fi in factors[k:]:
        h = mod_mul(h, fi, p)
    s, t = _mod_gcdex(g, h, p)
    m = p
    for _ in range(d):
        g, h, s, t = _hensel_step(m, f, g, h, s, t)
        m *= m
    pl = p ** l
    g, h = [x % pl for x in g], [x % pl for x in h]
    return hensel_lift(p, g, factors[:k], l) + \
        hensel_lift(p, h, factors[k:], l)


# ---------------------------------------------------------------------------
# Zassenhaus
# ---------------------------------------------------------------------------

def _primes_from(start: int):
    k = start
    while True:
        if k > 1 and all(k % q for q in range(2, math.isqrt(k) + 1)):
            yield k
        k += 1


def _mignotte(f: Poly) -> int:
    n = len(f) - 1
    a = math.isqrt(sum(x * x for x in f)) + 1
    return 2 ** n * a * abs(f[0])


def _exact_quo(f: Poly, g: Poly) -> Optional[Poly]:
    """f / g over ℤ where it is exact, else None."""
    f, q = list(f), []
    while len(f) >= len(g):
        c, rem = divmod(f[0], g[0])
        if rem:
            return None
        q.append(c)
        for i, x in enumerate(g):
            f[i] -= c * x
        f.pop(0)
    return q if not any(f) else None


def _primitive(f: Poly) -> Poly:
    g = 0
    for x in f:
        g = math.gcd(g, x)
    f = [x // g for x in f]
    return [-x for x in f] if f[0] < 0 else f


def zassenhaus(f: Poly) -> List[Poly]:
    """The irreducible factors over ℤ of a squarefree primitive f of degree
    ≥ 1 with a positive leading coefficient (each primitive, positive
    leading coefficient), in no particular order."""
    n = len(f) - 1
    if n == 1:
        return [f]
    lc = f[0]
    best = None
    tried = 0
    for p in _primes_from(3):
        if lc % p == 0 or not squarefree_mod([x % p for x in f], p):
            continue
        fac = factor_mod(f, p)
        if best is None or len(fac) < len(best[1]):
            best = (p, fac)
        tried += 1
        if tried == 5 or len(fac) == 1:
            break
    p, modular = best
    if len(modular) == 1:
        return [f]
    bound = 2 * _mignotte(f) * lc
    l = 1
    while p ** l <= bound:
        l += 1
    pl = p ** l
    lifted = hensel_lift(p, f, modular, l)
    found: List[Poly] = []
    s = 1
    T = list(range(len(lifted)))
    while 2 * s <= len(T):
        hit = False
        for S in itertools.combinations(T, s):
            G = [lc]
            for i in S:
                G = mod_mul(G, lifted[i], pl)
            G = _primitive(_sym(G, pl))
            q = _exact_quo(f, G)
            if q is None:
                continue
            found.append(G)
            f = _primitive(q)
            lc = f[0]
            T = [i for i in T if i not in S]
            hit = True
            break
        if not hit:
            s += 1
    found.append(_primitive(f))
    return found


def factor_squarefree(f: Poly) -> List[Poly]:
    """The irreducible factors over ℤ of the squarefree primitive f with a
    positive leading coefficient (zero roots and all)."""
    if len(f) - 1 <= 1:
        return [f]
    return zassenhaus(f)
