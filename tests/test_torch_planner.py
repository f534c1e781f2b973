"""The port's determinant planner (``linalg_solver_tpu_torch.planner``)
against the JAX package's: on 60 random sparse patterns (n ≤ 6, density
0.3–0.6, ``tests/test_golden_fuzz.py``'s draw), the optimal cost and the
serialized process are equal with the Python engine on both sides
(``LINALG_TPU_NATIVE=0``), and again with the native engine on both
sides (the port's library built here with ``g++``; the JAX one as its
own ``native.py`` finds it, the test skipped only where it is absent).
Also the DM decomposition, canonical forms and permutation equivalence,
and that a failed native build raises instead of falling back."""

import pytest

import linalg_solver_tpu.planner as jplan
import linalg_solver_tpu_torch.planner as tplan
from linalg_solver_tpu.planner import native as jnative
from linalg_solver_tpu.planner.serialize import process_to_dict as jdict
from linalg_solver_tpu_torch.planner import native as tnative
from linalg_solver_tpu_torch.planner.serialize import (
    dumps_plan,
    loads_plan,
    process_to_dict as tdict,
)

from torch_text_cases import addrow_patterns, chunks, dm_patterns
from torch_text_cases import fuzz_patterns, pattern

PATTERNS = [pattern(m) for m in fuzz_patterns(60)]
CHUNKS = chunks(PATTERNS, 6)


def _plans_agree(patterns):
    for p in patterns:
        jr = jplan.find_optimal_determinant_process(p)
        tr = tplan.find_optimal_determinant_process(p)
        assert ((tr.cost.multiplications, tr.cost.additions)
                == (jr.cost.multiplications, jr.cost.additions)), p
        assert tdict(tr.process) == jdict(jr.process), p


@pytest.mark.parametrize("chunk", range(len(CHUNKS)))
def test_python_engines_agree(chunk, monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    _plans_agree(CHUNKS[chunk])


def test_native_engines_agree(monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "1")
    if not jnative.is_available():
        pytest.skip("the JAX package's native planner library is absent")
    _plans_agree(PATTERNS + [pattern(m) for m in dm_patterns(8)]
                 + [pattern(m) for m in addrow_patterns(8)])


@pytest.mark.parametrize("engine", ["0", "1"])
def test_structure_agrees(engine, monkeypatch):
    """DM blocks, canonical hashes and permutation equivalence on both
    sides, each engine; and a plan survives its JSON round trip."""
    monkeypatch.setenv("LINALG_TPU_NATIVE", engine)
    if engine == "1" and not jnative.is_available():
        pytest.skip("the JAX package's native planner library is absent")
    pats = PATTERNS[:20] + [pattern(m) for m in dm_patterns(6)]
    for p in pats:
        jd, td = jplan.dm_decomposition(p), tplan.dm_decomposition(p)
        assert td.row_perm.perm == jd.row_perm.perm
        assert td.col_perm.perm == jd.col_perm.perm
        assert list(td.block_sizes) == list(jd.block_sizes)
        jc, tc = jplan.canonicalize_matrix(p), tplan.canonicalize_matrix(p)
        assert tc.canonical_hash == jc.canonical_hash
        assert tc.row_perm.perm == jc.row_perm.perm
        assert tc.col_perm.perm == jc.col_perm.perm
    for a, b in zip(pats, pats[1:] + pats[:1]):
        q = [row[::-1] for row in a[::-1]]
        assert (tplan.check_permutation_equivalent(a, q)
                == jplan.check_permutation_equivalent(a, q))
        assert (tplan.check_permutation_equivalent(a, b)
                == jplan.check_permutation_equivalent(a, b))
    r = tplan.find_optimal_determinant_process(pats[0])
    cost, proc = loads_plan(dumps_plan(r.cost, r.process))
    assert cost == r.cost and tdict(proc) == tdict(r.process)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A native build that fails raises from the planner's entry point;
    the Python engine is taken only where ``LINALG_TPU_NATIVE=0`` asks."""
    bad = tmp_path / "planner.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("LINALG_TPU_NATIVE", "1")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native planner build failed"):
        tplan.find_optimal_determinant_process(PATTERNS[0])
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(OSError):
        tplan.find_optimal_determinant_process(PATTERNS[0])
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    assert tplan.find_optimal_determinant_process(PATTERNS[0]).cost
