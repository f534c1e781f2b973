"""A pool of gloo ranks on the CPU for the port's mesh tests.

``Pool(world)`` spawns ``world`` processes, each rank of one
``torch.distributed`` gloo world on ``127.0.0.1`` with one PyTorch
thread; ``pool.run(job, *args)`` runs the function ``job`` of this module
on every rank with the same arguments and returns the ranks' results in
rank order (the first rank's traceback is raised if any rank failed).
This module imports only torch, numpy and the port, so the ranks never
import JAX; the tests hold their results against the JAX package in the
pytest process.

Jobs take and return numpy arrays: ``call`` runs one port function on a
``("dp", "tp")`` mesh (``MESH`` in its arguments is replaced by the
mesh), optionally under a ``CommMeter``; the others drive what ``call``
cannot (the training step, the batch-sharded solver, the sharded
spectral pipeline, the dryrun).  A rank outside the job's mesh returns
None.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import queue
import socket
import traceback

import numpy as np
import torch

WORLD = 8
MESH = "__mesh__"
TIMEOUT = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, inbox, outbox):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
    while True:
        job = inbox.get()
        if job is None:
            break
        name, args, kwargs = job
        try:
            outbox.put((rank, True, globals()[name](*args, **kwargs)))
        except Exception:   # reported to the pool, which raises it
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Pool:
    def __init__(self, world: int = WORLD):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, port, self.inboxes[r],
                                        self.outbox))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, job: str, *args, **kwargs) -> list:
        for q in self.inboxes:
            q.put((job, args, kwargs))
        out, errors = [None] * self.world, {}
        for _ in range(self.world):
            try:
                rank, ok, res = self.outbox.get(timeout=TIMEOUT)
            except queue.Empty:
                raise RuntimeError(f"job {job}: a rank did not answer in "
                                   f"{TIMEOUT} s") from None
            if ok:
                out[rank] = res
            else:
                errors[rank] = res
        if errors:
            raise RuntimeError(f"job {job} failed on ranks "
                               f"{sorted(errors)}:\n{errors[min(errors)]}")
        return out

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


def _np(x):
    """Tensors, NamedTuples and dicts of them as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _np(getattr(x, f)) for f in x._fields}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def _torch(x):
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


def _mesh(dp, tp):
    from linalg_solver_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=dp, tp=tp, device_type="cpu")
    return mesh if mesh.get_coordinate() is not None else None


def _fn(path: str):
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(
        f"linalg_solver_tpu_torch.{module}"), name)


def call(path, dp, tp, args, kwargs=None, meter=False):
    """``path`` (``"parallel.distributed_lu.distributed_solve"``) on the
    ``(dp, tp)`` mesh: ``{"out": result, "meter": {...} or None,
    "coord": (i, j)}``."""
    from linalg_solver_tpu_torch.parallel import comm

    mesh = _mesh(dp, tp)
    if mesh is None:
        return None
    args = [mesh if isinstance(a, str) and a == MESH else _torch(a)
            for a in args]
    kwargs = {k: _torch(v) for k, v in (kwargs or {}).items()}
    fn = _fn(path)
    if meter:
        with comm.CommMeter() as m:
            out = fn(*args, **kwargs)
        return {"out": _np(out), "meter": m.as_dict(),
                "coord": tuple(mesh.get_coordinate())}
    return {"out": _np(fn(*args, **kwargs)), "meter": None,
            "coord": tuple(mesh.get_coordinate())}


def collect(results, axis="tp", dim=0, field=None):
    """The global array from the ranks' shards along ``dim``: the shards of
    the ranks whose other coordinate is 0, in ``axis`` order (``field``
    picks a NamedTuple's field)."""
    k = 1 if axis == "tp" else 0
    parts = {}
    for r in results:
        if r is None or r["coord"][1 - k] != 0:
            continue
        v = r["out"] if field is None else r["out"][field]
        parts[r["coord"][k]] = v
    return np.concatenate([parts[i] for i in sorted(parts)], axis=dim)


def train(dp, tp, params, a, b, lr, steps=1):
    """``steps`` of ``make_training_step(mesh, lr)`` from ``params``:
    ``(params, [loss, …])`` after them (the replicated state)."""
    from linalg_solver_tpu_torch.models.solver import (TrainState,
                                                       make_training_step)

    mesh = _mesh(dp, tp)
    if mesh is None:
        return None
    step = make_training_step(mesh, lr=lr)
    state = TrainState(torch.from_numpy(params), torch.zeros((),
                                                             dtype=torch.int32))
    losses = []
    for _ in range(steps):
        state, loss = step(state, torch.from_numpy(a), torch.from_numpy(b))
        losses.append(float(loss))
    return state.params.numpy(), losses, int(state.step)


def batch_ops(dp, tp, ops, a, b=None, backend="auto"):
    """``BatchedSolver(mesh).<op>`` for each op under a meter, each beside
    the unsharded call's slice for this rank: ``{op: (sharded, slice of
    unsharded, meter)}``."""
    from linalg_solver_tpu_torch.models.solver import (BatchedSolver,
                                                       batch_shard_axes)
    from linalg_solver_tpu_torch.parallel import comm
    from linalg_solver_tpu_torch.parallel.mesh import shard

    mesh = _mesh(dp, tp)
    if mesh is None:
        return None
    a = torch.from_numpy(a)
    b = None if b is None else torch.from_numpy(b)
    sharded, plain = BatchedSolver(mesh=mesh, backend=backend), \
        BatchedSolver(backend=backend)
    axes = batch_shard_axes(mesh, a.shape[0])
    out = {}
    for op in ops:
        args = (a, b) if op == "solve" else (a,)
        with comm.CommMeter() as m:
            got = getattr(sharded, op)(*args)
        want = shard(getattr(plain, op)(*args), mesh, axes)
        out[op] = (got.numpy(), want.numpy(), m.as_dict())
    return out


def spectral_sharded(dp, tp, a, tol):
    """``spectral_pipeline_sharded`` on this rank's slice beside
    ``spectral_pipeline`` on the same slice."""
    from linalg_solver_tpu_torch.models import spectral
    from linalg_solver_tpu_torch.parallel import comm
    from linalg_solver_tpu_torch.parallel.mesh import shard_batch

    mesh = _mesh(dp, tp)
    if mesh is None:
        return None
    a = torch.from_numpy(a)
    with comm.CommMeter() as m:
        rep = spectral.spectral_pipeline_sharded(a, mesh, tol=tol)
    ref = spectral.spectral_pipeline(shard_batch(a, mesh), tol=tol)
    return {"coord": tuple(mesh.get_coordinate()), "out": _np(rep),
            "ref": _np(ref), "meter": m.as_dict()}


def collectives(dp, tp, x, perm):
    """``comm``'s psum, pmax, all_gather (stacked, tiled) and ppermute over
    tp on this rank's row of ``x`` (row = rank), and the meter."""
    import torch.distributed as dist

    from linalg_solver_tpu_torch.parallel import comm

    mesh = _mesh(dp, tp)
    if mesh is None:
        return None
    g = mesh.get_group("tp")
    r = dist.get_rank()
    v = torch.from_numpy(x[r:r + 1])
    with comm.CommMeter() as m:
        out = (comm.psum(v, g), comm.pmax(v, g), comm.all_gather(v, g),
               comm.all_gather(v, g, tiled=True), comm.ppermute(v, g, perm))
    return _np(out) + (m.as_dict(),)


def raises(path, dp, tp, args):
    """The exception type name and message ``call`` raises, or None."""
    try:
        call(path, dp, tp, args)
    except Exception as e:   # noqa: BLE001 - reported to the test
        return type(e).__name__, str(e)
    return None


def dryrun(n):
    from linalg_solver_tpu_torch.graft_entry import dryrun_multichip

    return dryrun_multichip(n, device="cpu")


def mesh_info(dp, tp):
    """``make_mesh``'s axis names, shape and this rank's coordinate, or the
    error it raised."""
    from linalg_solver_tpu_torch.parallel.mesh import make_mesh

    try:
        mesh = make_mesh(dp=dp, tp=tp, device_type="cpu")
    except ValueError as e:
        return "ValueError", str(e)
    coord = mesh.get_coordinate()
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            None if coord is None else tuple(coord))


def replicate_ranks(dp, tp, x):
    """``parallel.mesh.replicate`` of ``x + rank`` (each rank's own
    tensor): the mesh's first rank's on every rank."""
    import torch.distributed as dist

    from linalg_solver_tpu_torch.parallel.mesh import replicate

    mesh = _mesh(dp, tp)
    if mesh is None:
        return None
    return replicate(torch.from_numpy(x) + dist.get_rank(), mesh).numpy()
