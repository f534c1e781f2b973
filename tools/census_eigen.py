"""The eigenvalue census: the port's ``Matrix.eigenvalues`` against the JAX
package's on 150 random 3×3 and 150 random 4×4 integer matrices (entries
``randint(-5, 5)``, each size drawn from its own ``random.Random(0)``,
handed to both packages as Python ints, so that a non-fraction-free
AddRow step makes float coefficients in both), under both ``real_only``
settings, the JAX package's call cut at 20 s.  A development check on the
CPU; it needs sympy and jax, which the port does not.

    PYTHONPATH=. python3 tools/census_eigen.py [--sizes 3,4]

``COUNT`` = 150 matrices a size, the JAX call cut at ``LIMIT`` = 20 s,
``WORKERS`` = 4 threads, each with its own JAX process.  For each call it
prints nothing unless the two differ; at the end, one line per size with
the counts of each outcome:

- ``same``: both wrote the same text, byte for byte;
- ``both raise``: both raised (the port's exception type is listed);
- ``jax slow`` / ``jax division``: the JAX package ran out of time or
  raised ``PolynomialDivisionFailed`` in its factored line, and the port's
  roots line is byte for byte ``sympy.roots`` as the JAX ``cformat``
  writes it, and its factored line (if any) multiplies out to the
  characteristic polynomial at 40 digits;
- ``lone-root line``: the texts differ only in the factored line of a
  ``real_only`` call that keeps some of an irreducible factor's radical
  roots, which the JAX package writes and the port leaves out
  (``LoneRootQuotient``, ROADMAP.md queue 1 item 7);
- ``sympy evalf noise``: the texts differ only in the term order and
  branch of the roots (in the roots line, and in the factored line where
  both write one), where Ferrari's formula takes the cube root of a
  complex or negative number and sympy orders and branches the terms by
  the rounding noise of ``evalf`` (not ported: ROADMAP.md queue 1 item
  7): every other line is byte for byte, the roots are ``sympy.roots``'
  one to one in value with the same multiplicities and ``is_real``
  (``sweep_radicals.roots_differ``, so the same set under ``real_only``),
  and the port's factored line multiplies out to the characteristic
  polynomial at 40 digits;
- ``port raises`` (by exception type) and ``differ``: failures.

Exits 1 if any call is a failure.
"""

import argparse
import multiprocessing as mp
import os
import random
import sys
import threading
import time
from collections import Counter
from decimal import Decimal, localcontext
from fractions import Fraction

from linalg_solver_tpu_torch.exact.radexpr import numeric
from tools.sweep_radicals import ferrari_complex, roots_differ, sympy_values

COUNT = 150
LIMIT = 20.0
WORKERS = 4
FACTORED = "Rozložený tvar"
ROOTS = "algebraickými"
#: the outcomes that are not failures
OK = ("same", "jax slow", "jax division", "lone-root line",
      "both raise (ValueError)", "sympy evalf noise")


def matrices(n: int, count: int):
    rng = random.Random(0)
    return [[[rng.randint(-5, 5) for _ in range(n)] for _ in range(n)]
            for _ in range(count)]


def _jax_worker(conn):
    """Runs the JAX package's ``eigenvalues`` (or ``sympy.roots`` of a
    polynomial: the roots line's text and ``sympy_values``) for the
    parent, one task at a time."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from linalg_solver_tpu.exact.matrix import Matrix
    from linalg_solver_tpu.exact.polynomial import Polynomial
    from linalg_solver_tpu.utils import trace
    from linalg_solver_tpu.utils.fmt import cformat
    while True:
        task = conn.recv()
        if task is None:
            return
        kind, payload, real_only = task
        try:
            if kind == "eig":
                text = trace.capture_logs(
                    lambda: Matrix(payload).eigenvalues(real_only=real_only))
                conn.send(("ok", text))
            else:
                roots = Polynomial(payload, r"\lambda").radical_roots()
                if real_only:
                    roots = {r: m for r, m in roots.items()
                             if getattr(r, "is_real", None) is True
                             or isinstance(r, (int, float))}
                conn.send(("ok", (", ".join(
                    f"${cformat(r)}$ (multiplicity {m})"
                    for r, m in roots.items()), sympy_values(roots))))
        except Exception as e:                     # noqa: BLE001
            conn.send(("raise", type(e).__name__))


class Jax:
    """One JAX worker process, restarted after a call that runs out of
    time."""

    def __init__(self):
        self.proc = None

    def _start(self):
        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_jax_worker, args=(child,),
                                daemon=True)
        self.proc.start()

    def call(self, task, limit):
        if self.proc is None:
            self._start()
            self.conn.send(("roots", {1: 1}, False))      # warm up
            self.conn.recv()
        self.conn.send(task)
        if self.conn.poll(limit):
            return self.conn.recv()
        self.proc.kill()
        self.proc.join()
        self.proc = None
        return ("slow", None)

    def close(self):
        if self.proc is not None:
            self.conn.send(None)
            self.proc.join(5)
            if self.proc.is_alive():
                self.proc.kill()


def factored_right(poly, roots) -> bool:
    """Whether the port's factored form of ``poly`` (``factor_roots`` of
    ``roots``) multiplies out to it at 40 digits, evaluated at three
    points; True where the port writes no factored line."""
    try:
        factors = poly.factor_roots(list(roots.items()))
    except (ValueError, NotImplementedError):
        return True                          # no factored line written
    with localcontext() as ctx:
        ctx.prec = 50
        for t in (Decimal("0.37"), Decimal("-1.9"), Decimal("2.3")):
            want, got = Decimal(0), (Decimal(1), Decimal(0))
            for e, c in poly.powers.items():
                want += numeric(c, 50)[0] * t ** e
            for f, m in factors.items():
                a, b = Decimal(0), Decimal(0)
                for e, c in f.powers.items():
                    re_, im_ = numeric(c, 50)
                    a += re_ * t ** e
                    b += im_ * t ** e
                for _ in range(m):
                    got = (got[0] * a - got[1] * b, got[0] * b + got[1] * a)
            scale = 1 + abs(want)
            if abs(got[0] - want) + abs(got[1]) > Decimal(10) ** -40 * scale:
                return False
    return True


def _port(rows, real_only):
    from linalg_solver_tpu_torch.exact import Matrix
    from linalg_solver_tpu_torch.utils import trace
    box = []
    try:
        text = trace.capture_logs(
            lambda: box.append(Matrix(rows).eigenvalues(real_only=real_only)))
    except Exception as e:                         # noqa: BLE001
        return "raise", type(e).__name__, None
    return "ok", text, box[0]


def char_poly(rows):
    """The port's characteristic polynomial det(A − λI) of ``rows``."""
    from linalg_solver_tpu_torch.exact import Matrix
    from linalg_solver_tpu_torch.exact.polynomial import Polynomial
    from linalg_solver_tpu_torch.utils import trace
    n = len(rows)
    lam = Polynomial({1: 1}, var=r"\lambda")
    box = []
    trace.capture_logs(lambda: box.append(
        (Matrix(rows) - Matrix.diagonal([lam] * n)).determinant()))
    return box[0]


def _lone_root(rows, jtext, ptext, proots) -> bool:
    """Whether the texts differ only in the factored line that the JAX
    package writes and the port leaves out, the port's division raising
    ``LoneRootQuotient`` (ROADMAP.md queue 1 item 7: the quotient by some
    of an irreducible factor's radical roots)."""
    from linalg_solver_tpu_torch.exact.polynomial import LoneRootQuotient
    if FACTORED in ptext:
        return False
    if [ln for ln in jtext.splitlines() if FACTORED not in ln] != \
            ptext.splitlines():
        return False
    try:
        char_poly(rows).factor_roots(list(proots.items()))
    except LoneRootQuotient:
        return True
    return False


#: the port's log is one stack per process: one port call at a time
PORT = threading.Lock()


def _ferrari_complex(poly) -> bool:
    """``sweep_radicals.ferrari_complex`` of a rational characteristic
    polynomial (a float one takes ``nroots``: no Ferrari)."""
    powers = poly.powers
    if not all(isinstance(c, (int, Fraction)) for c in powers.values()):
        return False
    deg = max(powers)
    return ferrari_complex([powers.get(e, 0) for e in range(deg, -1, -1)])


def _evalf_noise(poly, proots, values, jtext=None, ptext=None) -> bool:
    """Whether the port's text differs from the JAX package's only in the
    term order and branch of Ferrari's roots (the module docstring's
    ``sympy evalf noise``): ``values`` are ``sympy.roots``' for this call
    (``sympy_values``); ``jtext`` is the JAX package's whole text, where
    it finished."""
    if not _ferrari_complex(poly) or roots_differ(proots, values) is not None:
        return False
    if jtext is not None:
        def rest(text):
            return [ln for ln in text.splitlines()
                    if ROOTS not in ln and FACTORED not in ln]
        if rest(jtext) != rest(ptext) or \
                (FACTORED in jtext) != (FACTORED in ptext):
            return False
    return factored_right(poly, proots)


def judge(rows, real_only, jax: Jax, limit=LIMIT):
    with PORT:
        kind, ptext, proots = _port(rows, real_only)
    jkind, jtext = jax.call(("eig", rows, real_only), limit)
    if kind == "raise":
        if jkind == "raise":
            return f"both raise ({ptext})"
        return f"port raises {ptext}"
    if jkind == "ok" and jtext == ptext:
        return "same"
    if jkind == "raise" and jtext != "PolynomialDivisionFailed":
        return f"jax raises {jtext}"
    with PORT:
        poly = char_poly(rows)
    rkind, want = jax.call(("roots", dict(poly.powers), real_only), limit)
    if rkind != "ok":
        return f"sympy.roots {rkind}"
    line, values = want
    with PORT:
        if jkind == "ok":
            if _lone_root(rows, jtext, ptext, proots):
                return "lone-root line"
            noise = _evalf_noise(poly, proots, values, jtext, ptext)
            return "sympy evalf noise" if noise else "differ"
        # the JAX package did not finish: hold the roots line to
        # sympy.roots
        if not factored_right(poly, proots):
            return "differ"
        mine = [ln for ln in ptext.splitlines() if ROOTS in ln][0]
        if not mine.endswith(line):
            noise = _evalf_noise(poly, proots, values)
            return "sympy evalf noise" if noise else "differ"
    return "jax slow" if jkind == "slow" else "jax division"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="3,4")
    args = ap.parse_args()
    os.environ.setdefault("LINALG_TPU_NATIVE", "0")
    failed = False
    for n in [int(s) for s in args.sizes.split(",")]:
        tasks = [(i, rows, ro) for i, rows in enumerate(matrices(n, COUNT))
                 for ro in (False, True)]
        results, lock = {}, threading.Lock()
        t0 = time.perf_counter()

        def run():
            jax = Jax()
            while True:
                with lock:
                    if not tasks:
                        break
                    i, rows, ro = tasks.pop(0)
                verdict = judge(rows, ro, jax)
                with lock:
                    results[(i, ro)] = verdict
                    if verdict not in OK:
                        print(f"{n}x{n} #{i} real_only={ro}: {verdict} "
                              f"{rows}", flush=True)
            jax.close()

        threads = [threading.Thread(target=run) for _ in range(WORKERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        counts = Counter(results.values())
        bad = sum(v for k, v in counts.items() if k not in OK)
        failed |= bad > 0
        print(f"{n}x{n}: {len(results)} calls in "
              f"{time.perf_counter() - t0:.0f} s: " + ", ".join(
                  f"{k} {v}" for k, v in sorted(counts.items())), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
