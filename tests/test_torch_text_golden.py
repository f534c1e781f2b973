"""BASELINE config 1's text against its golden file,
``tests/data_torch/text_config1.tex``, which ``chip_smoke.py`` holds the
card's host to (that host has no JAX and no sympy): the JAX package
writes exactly that file, and so does the port (both with the Python
planner engine, ``LINALG_TPU_NATIVE=0``).  The replayed lanes of
``chip_smoke.py``'s text phase: the count whose replayed text equals the
exact path's is the same for both packages' CPU runs on the same lanes,
and is the count the script pins (``TEXT_MATCHED``).  The phase itself
is rehearsed on the CPU."""

import importlib
import pathlib
from fractions import Fraction

import numpy as np
import sympy
import torch

import chip_smoke as cs
from linalg_solver_tpu.exact import elimination as jel
from linalg_solver_tpu.exact.matrix import Matrix as JMatrix
from linalg_solver_tpu.trace import events as jev
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch.exact import Matrix as TMatrix
from linalg_solver_tpu_torch.ops.rref import rref_batched
from linalg_solver_tpu_torch.trace import events as tev
from linalg_solver_tpu_torch.utils import trace as ttrace

jrref = importlib.import_module("linalg_solver_tpu.ops.rref")

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / cs.TEXT_GOLDEN


def _golden() -> str:
    return GOLDEN.read_text(encoding="utf-8")


def test_jax_package_writes_the_golden_file(monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    text = jtrace.capture_logs(lambda: cs.config1_derivation(
        JMatrix, jtrace.log, sympy.Rational, cs.config1_inputs()))
    assert text == _golden()


def test_port_writes_the_golden_file(monkeypatch):
    monkeypatch.setenv("LINALG_TPU_NATIVE", "0")
    box = []
    text = ttrace.capture_logs(lambda: box.append(cs.config1_derivation(
        TMatrix, ttrace.log, Fraction, cs.config1_inputs())))
    assert text == _golden()
    sol, dets = box[0]
    assert dets == [888, -1194]
    a, b = cs.config1_inputs()[:2]
    assert all(sum(a[i][j] * sol.vec[j] for j in range(8)) == b[i]
               for i in range(8))


def _jax_matches(host, events, num_events):
    exact = jev._to_exact(host)
    _, _, snaps, steps = jel.row_reduce(exact, bar_col=8)
    want = jtrace.capture_logs(lambda: jel.log_row_reduction_progress(
        snaps, steps, len(exact[0]), True, True))
    got = jtrace.capture_logs(lambda: jev.log_replayed_reduction(
        host, events, num_events, bar_col=8))
    return want == got


def test_replayed_lane_count_is_the_jax_packages():
    a, b = (x[:cs.TEXT_REPLAYED] for x in cs.text_lanes())
    aug = np.concatenate([a, b[:, :, None]], axis=2).astype(np.float32)
    rj = jrref.rref_batched(aug, bar_col=8, tol=tev.REPLAY_TOL,
                            pivot_rule="first")
    rt = rref_batched(torch.from_numpy(aug), bar_col=8, tol=tev.REPLAY_TOL,
                      pivot_rule="first")
    evj, nej = np.asarray(rj.events), np.asarray(rj.num_events)
    assert np.array_equal(rt.events.numpy(), evj)
    assert np.array_equal(rt.num_events.numpy(), nej)
    jax_lanes = [_jax_matches(aug[k], evj[k], int(nej[k]))
                 for k in range(len(aug))]
    port_lanes = [tev.replay_matches_exact(aug[k], rt.events[k], int(nej[k]),
                                           bar_col=8)
                  for k in range(len(aug))]
    assert port_lanes == jax_lanes
    assert sum(port_lanes) == cs.TEXT_MATCHED


def test_text_phase_rehearsed_on_the_cpu():
    out = cs.drive_text(torch.device("cpu"), lanes=512)
    assert out["matched"] == cs.TEXT_MATCHED
