"""Communication-volume accounting for the distributed single-matrix
paths (counterpart of ``linalg_solver_tpu.parallel.comm``).

Every collective of ``parallel/`` goes through the thin wrappers here
(``psum``, ``pmax``, ``all_gather``, ``ppermute``), which run
the ``torch.distributed`` (c10d) call on the group of one mesh axis.
While a :class:`CommMeter` is active, each wrapper records its call and
the payload bytes of its local operand as it runs.  The analytic models
below give the same counts as static functions of (n, nb, D, sweeps), so
a test can hold an implementation against its model exactly.

The reference records at trace time, so a collective inside a device
loop is traced once and its ``loop_scale`` context multiplies the record
by the loop's trip count.  Here every loop is a Python loop and every
call is recorded as it happens: ``loop_scale`` is kept as a no-op
context so that callers read the same, and an adaptive loop (the eigh
sweeps) is recorded with the sweeps it actually ran, which is
``model_eigh_adaptive(..., sweeps_used)`` (the reference's meter sees
``model_eigh_adaptive(..., 1)``, one traced sweep).

With no meter active the wrappers are the bare c10d calls.

Scaling model (per device, payload bytes; D = mesh axis size):

- ``distributed_lu`` factor: one ``[N, nb]`` panel-broadcast psum per
  phase: ``m = N/nb`` calls, ``4·N²`` bytes.
- ``distributed_lu`` solve body: ``m`` diagonal-block psums
  (``4·N·nb`` bytes in all) and ``2(m−1)`` substitution-contribution
  psums (``≈ 4·(m−1)·N·K`` bytes for K right-hand sides).
- ``distributed_eigh``: per Brent–Luk round (p = D block pairs,
  w = n/2p block width): 9 ppermutes (two ``[n, w]`` content rings and
  one index ring: ``24·n·w + 12`` bytes) and 3 all_gathers (the
  ``[2w, 2w]`` rotation and two scalars); each sweep is ``2p−1`` rounds
  and 2 convergence psums.

The α-β time model carries no constant of any interconnect: its callers
give the per-hop latency ``alpha`` (seconds) and the per-link bandwidth
``bw`` (bytes a second) of the fabric they project onto.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


class CommMeter:
    """Records collective calls and their local payload bytes as they run.

    ``with CommMeter() as meter: ...``; ``meter.calls`` and
    ``meter.bytes`` are Counters by collective kind."""

    _active = None

    def __init__(self):
        self.calls = Counter()
        self.bytes = Counter()

    def record(self, kind: str, x) -> None:
        xs = x if isinstance(x, (tuple, list)) else (x,)
        self.calls[kind] += 1
        self.bytes[kind] += sum(t.numel() * t.element_size() for t in xs)

    def __enter__(self):
        if CommMeter._active is not None:
            raise RuntimeError("CommMeter already active")
        CommMeter._active = self
        return self

    def __exit__(self, *exc):
        CommMeter._active = None
        return False

    def as_dict(self):
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


@contextmanager
def loop_scale(trips: int):
    """No-op.  The reference multiplies trace-time records by a static loop
    trip count here; this package records each call as it runs, so the
    count needs no multiplier."""
    yield


def _record(kind: str, x) -> None:
    m = CommMeter._active
    if m is not None:
        m.record(kind, x)


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (an all-reduce)."""
    _record("psum", x)
    return _reduce(x, group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    _record("pmax", x)
    return _reduce(x, group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, group, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in group order: stacked along a new leading axis,
    or (``tiled``) concatenated along axis 0."""
    _record("all_gather", x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts) if tiled else torch.stack(parts)


def ppermute(x: torch.Tensor, group,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` pair of group ranks, ``dst``
    receives ``src``'s ``x``; a rank that receives nothing gets zeros."""
    _record("ppermute", x)
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops: List[dist.P2POp] = []
    for src, dst in perm:
        if src == me and dst == me:
            out = x.clone()
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


# ---------------------------------------------------------------------
# Analytic models (counts + payload bytes, per device)
# ---------------------------------------------------------------------

def model_lu_factor(n: int, nb: int, itemsize: int = 4) -> dict:
    """One masked ``[n, nb]`` panel-broadcast psum per phase."""
    m = n // nb
    return {
        "calls": {"psum": m},
        "bytes": {"psum": m * n * nb * itemsize},
    }


def model_lu_solve_body(
    n: int, nb: int, k_rhs: int = 1, itemsize: int = 4
) -> dict:
    """m diagonal-block psums + 2(m−1) substitution-contribution psums
    (forward ``[n−(j+1)nb, K]``, backward ``[j·nb, K]``)."""
    m = n // nb
    fwd = sum(n - (j + 1) * nb for j in range(m - 1))
    bwd = sum(j * nb for j in range(1, m))
    return {
        "calls": {"psum": m + 2 * (m - 1)},
        "bytes": {
            "psum": (m * nb * nb + (fwd + bwd) * k_rhs) * itemsize
        },
    }


def model_lu_solve(
    n: int, nb: int, k_rhs: int = 1, itemsize: int = 4
) -> dict:
    """``distributed_solve`` = factor + solve body."""
    return _add_models(model_lu_factor(n, nb, itemsize),
                       model_lu_solve_body(n, nb, k_rhs, itemsize))


def _add_models(*models: dict) -> dict:
    out = {"calls": Counter(), "bytes": Counter()}
    for m in models:
        out["calls"].update(m["calls"])
        out["bytes"].update(m["bytes"])
    return {"calls": dict(out["calls"]), "bytes": dict(out["bytes"])}


def _scale_model(m: dict, k: int) -> dict:
    return {
        "calls": {kk: v * k for kk, v in m["calls"].items()},
        "bytes": {kk: v * k for kk, v in m["bytes"].items()},
    }


def model_eigh_per_sweep(n: int, p: int, w: int,
                         itemsize: int = 4) -> dict:
    """ONE block-Jacobi sweep (= 2p−1 Brent–Luk rounds): per round 9
    ppermutes (two [n, w] content rings + one index ring) and 3
    all_gathers (the [2w, 2w] rotation + two index scalars), plus the
    adaptive convergence check's 2 scalar psums at the sweep end."""
    rounds = max(2 * p - 1, 1)
    out = {
        "calls": {"all_gather": 3 * rounds, "psum": 2},
        "bytes": {
            "all_gather": rounds * ((2 * w) * (2 * w) * itemsize
                                    + 2 * 4),
            "psum": 2 * itemsize,
        },
    }
    if p > 1:
        out["calls"]["ppermute"] = 9 * rounds
        out["bytes"]["ppermute"] = rounds * (
            6 * n * w * itemsize + 3 * 4
        )
    return out


def model_eigh_fixed(n: int, itemsize: int = 4) -> dict:
    """Sweep-count-independent cost: the pre-loop convergence check
    (2 scalar psums) + the final eigenvalue-replication psum ([n])."""
    return {
        "calls": {"psum": 3},
        "bytes": {"psum": (n + 2) * itemsize},
    }


def model_eigh_adaptive(n: int, p: int, w: int, sweeps_used: int,
                        itemsize: int = 4) -> dict:
    """Total comm of the adaptive ``distributed_eigh``: the fixed part
    plus ``sweeps_used`` per-sweep parts."""
    return _add_models(
        model_eigh_fixed(n, itemsize),
        _scale_model(model_eigh_per_sweep(n, p, w, itemsize),
                     sweeps_used),
    )


def model_eigh(n: int, p: int, w: int, sweeps: int,
               itemsize: int = 4) -> dict:
    """The reference's name for ``model_eigh_adaptive``."""
    return model_eigh_adaptive(n, p, w, sweeps, itemsize)


# ---------------------------------------------------------------------
# α-β (latency + bandwidth) time model: projected wall time of the
# modeled collectives on a D-device ring with per-hop latency ``alpha``
# (seconds) and per-link one-way bandwidth ``bw`` (bytes/second), both
# given by the caller for the fabric in question.
#
# Collective shapes on a bidirectional ring:
#
# - psum (all-reduce = reduce-scatter + all-gather): 2(D−1) hops of
#   latency; each byte crosses the ring twice at (D−1)/D efficiency.
# - all_gather: (D−1) hops; recorded payload is the LOCAL shard, each
#   shard forwarded (D−1) times.
# - ppermute: one hop per call (neighbor shifts in the Brent–Luk ring).
# - pmax: scalar all-reduce, latency only.
# ---------------------------------------------------------------------

def time_alpha_beta(model: dict, D: int, alpha: float, bw: float) -> float:
    """Projected seconds for the collectives of ``model`` on a D-device
    ring (α latency + β bandwidth terms per collective)."""
    if D <= 1:
        return 0.0
    t = 0.0
    calls, nbytes = model["calls"], model["bytes"]
    for kind, c in calls.items():
        b = nbytes.get(kind, 0)
        if kind == "psum":
            t += c * 2 * (D - 1) * alpha + 2 * b * (D - 1) / (D * bw)
        elif kind == "all_gather":
            t += c * (D - 1) * alpha + b * (D - 1) / bw
        elif kind == "ppermute":
            t += c * alpha + b / bw
        elif kind == "pmax":
            t += c * 2 * (D - 1) * alpha
        else:  # unknown collective: charge latency only
            t += c * alpha
    return t


def time_alpha_beta_band(model: dict, D: int, alpha: float, bw: float,
                         factors=(0.5, 1.0, 2.0)) -> tuple:
    """Sensitivity band (best, nominal, worst) seconds for ``model``:
    α and β each scaled by the given factors, "best" taking the
    optimistic end of both (α · lo, bw · hi) and "worst" the pessimistic
    (α · hi, bw · lo)."""
    lo, mid, hi = factors
    return (
        time_alpha_beta(model, D, alpha * lo, bw * hi),
        time_alpha_beta(model, D, alpha * mid, bw * mid),
        time_alpha_beta(model, D, alpha * hi, bw * lo),
    )


def projected_eigh_scaling(n: int, alpha: float, bw: float,
                           Ds=(8, 16, 64), sweeps: int = 4) -> list:
    """Projected α-β comm time of ``distributed_eigh`` per mesh size:
    rows of ``(D, rounds_per_sweep, total_s, per_sweep_s)`` for a fixed
    [n, n] problem (strong scaling: w shrinks as D grows)."""
    rows = []
    for D in Ds:
        if n % (2 * D):
            continue
        w = n // (2 * D)
        per_sweep = time_alpha_beta(
            model_eigh_per_sweep(n, D, w), D, alpha, bw
        )
        total = time_alpha_beta(
            model_eigh_adaptive(n, D, w, sweeps), D, alpha, bw
        )
        rows.append((D, max(2 * D - 1, 1), total, per_sweep))
    return rows


def projected_eigh_scaling_band(n: int, alpha: float, bw: float,
                                Ds=(8, 16, 64), sweeps: int = 4) -> list:
    """Strong-scaling projection with the α/β sensitivity band: rows of
    ``(D, rounds_per_sweep, (best_s, nominal_s, worst_s))``."""
    rows = []
    for D in Ds:
        if n % (2 * D):
            continue
        w = n // (2 * D)
        band = time_alpha_beta_band(
            model_eigh_adaptive(n, D, w, sweeps), D, alpha, bw
        )
        rows.append((D, max(2 * D - 1, 1), band))
    return rows
