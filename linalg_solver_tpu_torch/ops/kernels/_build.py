"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` of the package is compiled by its own
``nvcc`` for ``sm_90a`` (all started together) and the objects are
linked into one shared library with a plain C interface, which is
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library lands in ``linalg_solver_tpu_torch/_build/`` under a name
that carries a hash of the sources, headers and flags, so it is rebuilt
only when they change.  Without ``nvcc`` a build raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of each exported function: (restype, argtypes)
_SIGNATURES = {
    "solve_fused_rbt_f32": (_I, [_P] * 7 + [_I] * 5 + [_P]),
    "solve_fused_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "solve_variant": (_I, [_I, _I]),
    "solve_attributes": (_I, [_I] * 3 + [_P]),
    "gauss_jordan_f32": (_I, [_P] * 5 + [_I] * 3 + [_P]),
    "gj_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "gj_variant": (_I, [_I, _I]),
    "gj_attributes": (_I, [_I] * 3 + [_P]),
    "gj_cluster_size": (_I, [_I, _I]),
    "gj_cluster_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "gj_clusters": (_I, [_I, _I]),
    "inv_rbt_f32": (_I, [_P] * 9 + [_I] * 4 + [_P]),
    "inv_rbt_smem_bytes": (ctypes.c_size_t, [_I]),
    "inv_variant": (_I, [_I]),
    "inv_variant_smem": (ctypes.c_size_t, [_I, _I]),
    "inv_attributes": (_I, [_I] * 3 + [_P]),
    "butterfly_two_sided_f32": (_I, [_P] * 4 + [_I] * 5 + [_P]),
    "lu_nopivot_f32": (_I, [_P] * 3 + [_I] * 3 + [_P]),
    "nopivot_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "nopivot_variant": (_I, [_I, _I]),
    "nopivot_attributes": (_I, [_I] * 3 + [_P]),
    "lu_panel_f32": (_I, [_P] * 7 + [_I] * 3 + [_P]),
    "panel_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "panel_variant": (_I, [_I, _I]),
    "panel_attributes": (_I, [_I] * 3 + [_P]),
    "schur_chase": (_I, [_P] * 8 + [_I] * 6 + [_P]),
    "chase_variant": (_I, [_I] * 2),
    "chase_cluster_size": (_I, [_I] * 2),
    "chase_cluster_smem_bytes": (ctypes.c_size_t, [_I] * 2),
    "chase_clusters": (_I, [_I] * 2),
    "schur_window": (_I, [_P] * 8 + [_I] * 4 + [_P]),
    "schur_window_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "schur_window_attributes": (_I, [_I, _I, _P]),
    "schur_window_live_steps": (_I, [_P, _P]),
    "schur_window_live_reset": (_I, [_P]),
    "trsyl_masked": (_I, [_P] * 9 + [_I] * 4 + [_P]),
    "trsyl_attributes": (_I, [_I] * 3 + [_P]),
    "sturm_count": (_I, [_P] * 5 + [_I] * 4 + [_P]),
    "sturm_bisect": (_I, [_P] * 10 + [_I] * 3 + [_P]),
    "sturm_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "sturm_attributes": (_I, [_I, _P]),
    "complex_gauss": (_I, [_P] * 7 + [_I] * 3 + [_P]),
    "complex_gauss_variant": (_I, [_I, _I]),
    "complex_gauss_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "complex_gauss_attributes": (_I, [_I, _I, _P]),
    "kernels_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built on this machine"
    )


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> None:
    """Run the commands at once; raise with the output of those that
    failed, after all have ended."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the sources unless the library for them already exists:
    one ``nvcc -c`` per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(_sources(), objs)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def attributes(fn: str, variant: int, n: int, w: int) -> dict:
    """Registers a thread, local (spill) bytes a thread and resident
    blocks an SM of a kernel variant at ``[n, w]``, through the C entry
    point ``fn`` (``gj_attributes``, ``panel_attributes``,
    ``nopivot_attributes``, ``solve_attributes`` or ``inv_attributes``,
    which ignores ``w``)."""
    out = (ctypes.c_int * 3)()
    check(getattr(load(), fn)(variant, n, w, out), fn)
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
