"""The port's replay of device pivot events (``linalg_solver_tpu_torch
.trace``) against the JAX package's: the port's ``rref_batched`` events
on the CPU, replayed by the port, against the JAX ``rref_batched`` events
replayed by the JAX package, on the same numpy inputs — events equal,
texts byte for byte, reduced matrices equal as fractions; and
``replay_solve_trace`` on a batch passed in against the JAX function on
the same batch (its generators handed that batch), the text byte for
byte but for the device it names (``TPU`` there, ``CPU`` here)."""

import importlib

import numpy as np
import pytest
import torch

from linalg_solver_tpu.trace import events as jev
from linalg_solver_tpu.utils import trace as jtrace
from linalg_solver_tpu_torch.ops.rref import rref_batched
from linalg_solver_tpu_torch.trace import events as tev
from linalg_solver_tpu_torch.utils import trace as ttrace

from torch_text_cases import same_value

jrref = importlib.import_module("linalg_solver_tpu.ops.rref")
jgen = importlib.import_module("linalg_solver_tpu.ops.generate")


def _cases():
    """(name, [B, m, n] float32 integer-valued, bar_col, pivot_rule)."""
    rng = np.random.default_rng(16)
    sq = rng.integers(-5, 6, size=(12, 8, 9)).astype(np.float32)
    sq[3, 5] = sq[3, 1]                       # rank 7, consistent or not
    sq[7, :, 2] = 0                           # a zero column
    defic = (rng.integers(-2, 3, size=(6, 4, 2))
             @ rng.integers(-2, 3, size=(6, 2, 6))).astype(np.float32)
    a3 = rng.integers(-4, 5, size=(6, 3, 3)).astype(np.float32)
    inv = np.concatenate([a3, np.broadcast_to(np.eye(3, dtype=np.float32),
                                              a3.shape)], axis=2)
    return [("config1", sq, 8, "first"), ("config1-partial", sq, 8, "partial"),
            ("rank2", defic, 5, "first"), ("inverse", inv, 3, "first")]


@pytest.mark.parametrize("case", range(4))
def test_replay_matches_jax(case):
    name, a, bar, rule = _cases()[case]
    rj = jrref.rref_batched(a, bar_col=bar, tol=1e-5, pivot_rule=rule)
    rt = rref_batched(torch.from_numpy(a), bar_col=bar, tol=1e-5,
                      pivot_rule=rule)
    evj, nej = np.asarray(rj.events), np.asarray(rj.num_events)
    assert np.array_equal(rt.events.numpy(), evj), name
    assert np.array_equal(rt.num_events.numpy(), nej), name
    for k in range(a.shape[0]):
        jbox, tbox = [], []
        jtext = jtrace.capture_logs(lambda: jbox.append(
            jev.log_replayed_reduction(a[k], evj[k], int(nej[k]), bar)))
        ttext = ttrace.capture_logs(lambda: tbox.append(
            tev.log_replayed_reduction(a[k], rt.events[k], int(nej[k]),
                                       bar)))
        assert ttext == jtext, (name, k)
        assert all(same_value(t, j) for tr, jr in zip(tbox[0], jbox[0])
                   for t, j in zip(tr, jr))
        _, snaps, steps = tev.replay_rref_events(
            a[k], evj[k], int(nej[k]), bar)
        _, jsnaps, jsteps = jev.replay_rref_events(
            a[k], evj[k], int(nej[k]), bar)
        assert snaps == jsnaps and steps == jsteps


def test_replay_solve_trace_on_a_batch_passed_in(monkeypatch):
    rng = np.random.default_rng(5)
    a = rng.integers(-5, 6, size=(4, 3, 3)).astype(np.float32)
    a[0] = [[2, 1, -1], [-3, -1, 2], [-2, 1, 2]]
    b = rng.integers(-5, 6, size=(4, 3)).astype(np.float32)
    monkeypatch.setattr(jgen, "full_rank_batch",
                        lambda key, batch, n, lo, hi: a)
    monkeypatch.setattr(jgen, "random_batch",
                        lambda key, batch, m, n: b[:, :, None])
    jtext = jtrace.capture_logs(lambda: jev.replay_solve_trace(4, 3, 0))
    ttext = ttrace.capture_logs(lambda: tev.replay_solve_trace(
        device="cpu", systems=(a, b)))
    assert ttext == jtext.replace("řešena na TPU", "řešena na CPU")


def test_replay_solve_trace_draws_its_own_batch():
    """The port's own seeded draw on the CPU: the narrated solution solves
    lane 0 exactly and the determinants are the batch's."""
    from fractions import Fraction

    from linalg_solver_tpu_torch.exact import Matrix, from_reference_items
    from linalg_solver_tpu_torch.ops.generate import full_rank_batch
    from linalg_solver_tpu_torch.ops.generate import random_batch
    from linalg_solver_tpu_torch.utils.fmt import cformat

    text = ttrace.capture_logs(lambda: tev.replay_solve_trace(
        batch=3, n=4, seed=7, device="cpu"))
    gen = torch.Generator().manual_seed(7)
    a = full_rank_batch(gen, 3, 4, lo=-5, hi=5, device="cpu")
    b = random_batch(gen, 3, 4, 1, device="cpu")[:, :, 0]
    rows = [from_reference_items(m.int().tolist()) for m in a]
    x = Matrix(rows[0]).find_preimage_of(
        [Fraction(int(v)) for v in b[0]]).vec
    assert "řešena na CPU" in text
    assert r"$x = \left(%s\right)$" % ", ".join(map(cformat, x)) in text
    dets = [round(float(torch.det(m.double()))) for m in a]
    assert "$%s$" % ", ".join(map(str, dets)) in text


def test_unknown_event_raises():
    with pytest.raises(ValueError, match="Unknown event code"):
        tev.replay_rref_events([[1, 2], [3, 4]], np.array([[9, 0, 0]]), 1)
