"""The port's CLI against the JAX package's.

- ``main([-o F, --seed S, --quiet])`` writes the bytes the JAX package
  writes, in one process (Python planner engine on both sides), and
  equals the golden files ``tests/data_torch/cli_seed{2026,7,123}.tex``,
  which the JAX package writes and ``chip_smoke.py`` holds the card's
  host to;
- ``python -m linalg_solver_tpu_torch`` in a subprocess that refuses
  ``jax``, ``sympy`` and the JAX package writes the golden file (native
  planner engine, the default);
- ``device_section`` on the CPU with the JAX package's draws injected
  (its replay batch and its spectral batch) writes the JAX text but for
  the device's name (``CPU`` where the JAX text says ``TPU``);
- ``--device`` raises without a CUDA device.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from linalg_solver_tpu import cli as jcli
from linalg_solver_tpu.ops.generate import diagonalizable_batch as jdiag
from linalg_solver_tpu.ops.generate import full_rank_batch as jfull
from linalg_solver_tpu.ops.generate import random_batch as jrand
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch import cli as tcli
from linalg_solver_tpu_torch.utils import trace as ttrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = (2026, 7, 123)


def golden(seed: int) -> str:
    return (ROOT / "tests" / "data_torch" / f"cli_seed{seed}.tex").read_text(
        encoding="utf-8")


def _cli(cli, trace, tmp_path, seed, tag):
    """Run one package's ``main`` with ``--quiet`` into a file, leaving its
    global logger as it was; the file's text."""
    logger = trace.global_logger
    saved, echo = list(logger.accum), logger.auto_print
    logger.accum.clear()
    out = tmp_path / f"{tag}{seed}.tex"
    try:
        cli.main(["-o", str(out), "--seed", str(seed), "--quiet"])
    finally:
        logger.accum[:] = saved
        logger.auto_print = echo
    return out.read_text(encoding="utf-8")


def test_jax_package_writes_the_golden_files(tmp_path, monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    for seed in SEEDS:
        jtext = _cli(jcli, jtrace, tmp_path, seed, "j")
        assert jtext == golden(seed), seed


def test_port_equals_the_jax_package_in_process(tmp_path, monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    jtext = _cli(jcli, jtrace, tmp_path, 2026, "j")
    ttext = _cli(tcli, ttrace, tmp_path, 2026, "t")
    assert ttext == jtext
    assert ttext.count(r"\section{") == 6


@pytest.mark.parametrize("seed", SEEDS)
def test_port_writes_the_golden_file(tmp_path, seed):
    assert _cli(tcli, ttrace, tmp_path, seed, "t") == golden(seed)


REFUSING_RUN = r"""
import importlib.abc, runpy, sys

REFUSED = ("jax", "jaxlib", "sympy", "linalg_solver_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


for name in list(sys.modules):
    if name.split(".")[0] in REFUSED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())
sys.argv = ["linalg_solver_tpu_torch"] + sys.argv[1:]
runpy.run_module("linalg_solver_tpu_torch", run_name="__main__",
                 alter_sys=True)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""


def test_module_runs_without_jax_or_sympy(tmp_path):
    out = tmp_path / "out.tex"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("LINALG_TPU_NATIVE", None)
    run = subprocess.run(
        [sys.executable, "-c", REFUSING_RUN, "-o", str(out), "--seed", "7",
         "--quiet"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout == ""
    assert out.read_text(encoding="utf-8") == golden(7)


def _jax_device_inputs(seed):
    """The JAX package's device draws: ``replay_solve_trace``'s systems
    and the spectral subsection's batch."""
    k_a, k_b = jax.random.split(jax.random.PRNGKey(0))
    A = np.array(jfull(k_a, 4, 3, lo=-5, hi=5))
    b = np.array(jrand(k_b, 4, 3, 1)[:, :, 0])
    batch = np.array(jdiag(jax.random.PRNGKey(seed), 4,
                             [4.0, 1.0, 1.0, -2.0], transform="orthogonal"))
    return (A, b), batch


def test_device_section_on_the_cpu_with_the_jax_draws():
    seed = 2026
    systems, batch = _jax_device_inputs(seed)
    jtext = jtrace.capture_logs(lambda: jcli.device_section(seed))
    ttext = ttrace.capture_logs(lambda: tcli.device_section(
        seed, device="cpu", systems=systems, batch=batch))
    assert "TPU" in jtext and "TPU" not in ttext
    assert ttext == jtext.replace("TPU", "CPU")
    assert r"\end{tabular}" in ttext


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device exists")
def test_device_flag_raises_without_cuda(tmp_path):
    logger = ttrace.global_logger
    saved, echo = list(logger.accum), logger.auto_print
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["-o", str(tmp_path / "d.tex"), "--device", "--quiet"])
    finally:
        logger.accum[:] = saved
        logger.auto_print = echo
    assert not (tmp_path / "d.tex").exists()
