"""ctypes binding to the C++ native planner (``csrc/planner.cpp``;
counterpart of ``linalg_solver_tpu.planner.native``).

The shared library returns JSON which this module deserializes into the
same ``Process`` / ``Cost`` / ``DMResult`` / ``CanonicalForm`` objects the
pure-Python engine produces, so the executor and all downstream code are
engine-agnostic.

At first use ``load`` compiles the source with
``g++ -O2 -std=c++17 -fPIC -shared`` (the compiler ``$CXX`` names, else
``g++``) into the package's ``_build/``, under a name that carries a hash
of the source and flags, so an edit rebuilds it.  A failed build raises:
nothing falls back to the Python engine unless ``LINALG_TPU_NATIVE=0``
asks for it (``planner._native_enabled``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from ..exact.permutation import Permutation
from .canonical import CanonicalForm
from .dm import DMResult
from .process import (
    AddRow,
    BlockTriangular,
    ColExpansion,
    Cost,
    Direct,
    Nonzeros,
    Process,
    RowExpansion,
)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "planner.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib = None
_lock = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("native planner: no C++ compiler (g++ or $CXX) to "
                           "build csrc/planner.cpp; set LINALG_TPU_NATIVE=0 "
                           "to use the Python engine")
    return cxx


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libplanner_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library already exists; raise with
    the compiler's output if it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native planner build failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded planner library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.planner_find_optimal.restype = ctypes.c_void_p
            lib.planner_find_optimal.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.planner_dm.restype = ctypes.c_void_p
            lib.planner_dm.argtypes = lib.planner_find_optimal.argtypes
            lib.planner_canonicalize.restype = ctypes.c_void_p
            lib.planner_canonicalize.argtypes = (
                lib.planner_find_optimal.argtypes)
            lib.planner_perm_equivalent.restype = ctypes.c_int
            lib.planner_perm_equivalent.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.planner_free.restype = None
            lib.planner_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def _pattern_bytes(matrix: List[List[bool]]) -> Tuple[bytes, int, int]:
    rows = len(matrix)
    cols = len(matrix[0]) if rows else 0
    data = bytes(
        1 if matrix[r][c] else 0 for r in range(rows) for c in range(cols)
    )
    return data, rows, cols


def _call_json(fn, *args) -> Optional[dict]:
    lib = load()
    ptr = fn(*args)
    if not ptr:
        return None
    try:
        return json.loads(ctypes.string_at(ptr).decode())
    finally:
        lib.planner_free(ptr)


def _parse_process(node: dict, size_hint: int) -> Process:
    kind = node["kind"]
    nz_entries = [(r, c) for r, c in node["nz"]]

    if kind == "Direct":
        raw = Direct(node["size"])
        dims = node["size"]
    elif kind in ("RowExpansion", "ColExpansion"):
        minors = [
            (idx, _parse_process(sub, size_hint - 1))
            for idx, sub in node["minors"]
        ]
        dims = size_hint
        if kind == "RowExpansion":
            raw = RowExpansion(node["row"], minors)
        else:
            raw = ColExpansion(node["col"], minors)
    elif kind == "BlockTriangular":
        row_perm = Permutation(node["row_perm"], _validate=False)
        col_perm = Permutation(node["col_perm"], _validate=False)
        blocks = []
        for sub in node["blocks"]:
            blocks.append(_parse_process(sub, _node_size(sub)))
        raw = BlockTriangular(blocks, row_perm, col_perm)
        dims = len(row_perm)
    elif kind == "AddRow":
        result = _parse_process(node["result"], size_hint)
        raw = AddRow(node["src"], node["dst"], node["pivot_col"], result)
        dims = size_hint
    else:
        raise ValueError(f"Unknown process kind: {kind}")

    return Process(raw, Nonzeros(dims, dims, nz_entries))


def _node_size(node: dict) -> int:
    kind = node["kind"]
    if kind == "Direct":
        return node["size"]
    if kind in ("RowExpansion", "ColExpansion"):
        if node["minors"]:
            return 1 + _node_size(node["minors"][0][1])
        return 1
    if kind == "BlockTriangular":
        return len(node["row_perm"])
    if kind == "AddRow":
        return _node_size(node["result"])
    raise ValueError(f"Unknown process kind: {kind}")


def find_optimal_process(
    matrix: List[List[bool]],
) -> Tuple[Cost, Process]:
    data, rows, cols = _pattern_bytes(matrix)
    obj = _call_json(load().planner_find_optimal, data, rows, cols)
    if obj is None:
        raise RuntimeError("native planner rejected the pattern")
    cost = Cost(obj["cost"]["mults"], obj["cost"]["adds"])
    process = _parse_process(obj["process"], rows)
    return cost, process


def dm_decomposition(matrix: List[List[bool]]) -> DMResult:
    data, rows, cols = _pattern_bytes(matrix)
    obj = _call_json(load().planner_dm, data, rows, cols)
    if obj is None:
        raise RuntimeError("native planner rejected the pattern")
    return DMResult(
        Permutation(obj["row_perm"], _validate=False),
        Permutation(obj["col_perm"], _validate=False),
        list(obj["block_sizes"]),
    )


def canonicalize_matrix(matrix: List[List[bool]]) -> CanonicalForm:
    data, rows, cols = _pattern_bytes(matrix)
    obj = _call_json(load().planner_canonicalize, data, rows, cols)
    if obj is None:
        raise RuntimeError("native planner rejected the pattern")
    return CanonicalForm(
        Permutation(obj["row_perm"], _validate=False),
        Permutation(obj["col_perm"], _validate=False),
        int(obj["hash"]),
    )


def check_permutation_equivalent(
    a: List[List[bool]], b: List[List[bool]]
) -> bool:
    da, rows, cols = _pattern_bytes(a)
    db, rb, cb = _pattern_bytes(b)
    if (rows, cols) != (rb, cb):
        return False
    res = load().planner_perm_equivalent(da, db, rows, cols)
    if res < 0:
        raise RuntimeError("native planner rejected the pattern")
    return bool(res)
