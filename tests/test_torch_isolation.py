"""The port stays importable on a host with no JAX and no sympy (the card's
host has neither): every module of ``linalg_solver_tpu_torch`` and
``chip_smoke`` is imported in a fresh interpreter whose import system
refuses ``jax``, ``jaxlib``, ``sympy``, ``mpmath`` and the JAX package."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "sympy", "mpmath", "linalg_solver_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


for name in list(sys.modules):
    if name.split(".")[0] in REFUSED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import linalg_solver_tpu_torch

names = ["linalg_solver_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(linalg_solver_tpu_torch.__path__,
                                          "linalg_solver_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_sympy():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    # the package, ops, ops.kernels, models, utils and their modules (with
    # ops.ordschur, pseudospectra, funm, nearness, fitting, ops.kernels.trsyl
    # and utils.draws: 52), and the exact text path: utils.fmt and
    # utils.trace, exact and its 5 modules, planner and its 9, trace and
    # trace.events (72), then cli, __main__, exact.radicals,
    # exact.random_matrix, ops.tridiag, ops.sturm, ops.kernels.sturm and
    # ops.randomized (80), then ops.dd, ops.complexlin,
    # ops.kernels.complex_gauss, linalg and utils.checkpoint (85), then
    # graft_entry, ops.krylov, toeplitz, structured, banded, lobpcg,
    # arnoldi, blocksparse and kron (94), then exact.radexpr (95)
    assert int(out.stdout.split()[-1]) >= 95
