"""The forward step of the flagship batched solve and its example
arguments (counterpart of the JAX package's root ``__graft_entry__.
entry``).

``entry()`` returns ``(forward, (a, b))``: ``forward(a, b)`` is
``dispatch.solve_batched(a, b, backend="auto")``, which takes the fused
solve kernel (``csrc/solve_fused.cu``) at this shape on a CUDA device,
and ``(a, b)`` is a seeded batch of B = 8 systems of N = 64: Gaussian
plus 4√N·I and a Gaussian right-hand side, drawn on a CPU generator and
then moved to the device.  Run it with ``python -m
linalg_solver_tpu_torch.graft_entry``.

``dryrun_multichip(n_devices, device=None)`` (the twin of the root
``__graft_entry__.dryrun_multichip``) runs the mesh layer's sequence on
the current ``torch.distributed`` world of ``n_devices`` ranks: the
training step, the batch-sharded solve with zero collectives (and the
indivisible-batch error), the distributed solve, least squares, tall
SVD, CG, dd solve and eigh with their collectives held against the
analytic models, and the weak-scaling comm model.  Every rank calls it;
rank 0 prints the figures on one line.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .utils.precision import f32_matmuls

#: the batch of the flagship step: B systems of N unknowns
B, N = 8, 64
SEED = 0


def example_args(device: torch.device | str) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``(a [B, N, N], b [B, N])`` f32 on ``device``, from a CPU
    generator seeded ``SEED``."""
    g = torch.Generator().manual_seed(SEED)
    a = torch.randn(B, N, N, generator=g) + 4.0 * N ** 0.5 * torch.eye(N)
    b = torch.randn(B, N, generator=g)
    return a.to(device), b.to(device)


def forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The flagship step: ``dispatch.solve_batched(a, b, "auto")``."""
    from .ops import dispatch

    return dispatch.solve_batched(a, b, backend="auto")


def entry(device: Optional[torch.device | str] = None
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """``(forward, (a, b))`` on ``device``; None means CUDA, which must be
    there (tests pass ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry() runs on a CUDA device and there is "
                               "none; pass device='cpu' for the CPU")
        device = "cuda"
    return forward, example_args(device)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _check(ok, what) -> None:
    """A failed check of the dryrun (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, float]:
    """The mesh sequence on the current world, which must have
    ``n_devices`` ranks (every rank calls it).  ``device`` None means the
    CUDA device (it must be there); tests pass ``"cpu"`` on a gloo world.
    Raises on the first failed check; returns the figures rank 0 prints."""
    import torch.distributed as dist

    from .models.solver import (BatchedSolver, batch_shard_axes,
                                init_train_state, make_training_step)
    from .ops import dispatch
    from .parallel import comm
    from .parallel.distributed_dd import distributed_solve_dd
    from .parallel.distributed_eigh import distributed_eigh
    from .parallel.distributed_krylov import distributed_cg
    from .parallel.distributed_lu import distributed_solve
    from .parallel.distributed_tall import (distributed_lstsq,
                                            distributed_svd_tall)
    from .parallel.mesh import (axis_index, default_device, make_mesh,
                                shard)

    dev = default_device(device)
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(
            f"dryrun_multichip needs an initialized process group of "
            f"{n_devices} ranks, found "
            f"{dist.get_world_size() if dist.is_initialized() else 0}")
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(dp=n_devices // tp, tp=tp, device_type=dev.type)
    dp = n_devices // tp
    fig: Dict[str, float] = {}

    # the training step: batch over dp, M's columns over tp
    Bt, Nt = 2 * n_devices, 8
    g = _gen(0)
    a = (torch.randn(Bt, Nt, Nt, generator=g) + 3.0 * torch.eye(Nt)).to(dev)
    b = torch.randn(Bt, Nt, generator=g).to(dev)
    state = init_train_state(Nt, device=dev)
    new_state, loss = make_training_step(mesh, lr=1e-3)(state, a, b)
    _check(int(new_state.step) == 1, "the step count")
    _check(bool(torch.isfinite(new_state.params).all()),
           "the trained parameters are not finite")
    fig["loss"] = float(loss)

    # the flagship batch path over the mesh: every rank runs the dispatch
    # stack on its slice, zero collectives, bitwise the unsharded lanes
    Bs, Ns = 2 * n_devices, 64
    g = _gen(42)
    a_s = (torch.randn(Bs, Ns, Ns, generator=g)
           + 4.0 * Ns ** 0.5 * torch.eye(Ns)).to(dev)
    b_s = torch.randn(Bs, Ns, generator=g).to(dev)
    axes = batch_shard_axes(mesh, Bs)
    _check(axes == ("dp", "tp"), axes)
    with comm.CommMeter() as meter:
        x_sh = BatchedSolver(mesh=mesh).solve(a_s, b_s)
    _check(meter.as_dict() == {"calls": {}, "bytes": {}}, meter.as_dict())
    x_ref = shard(dispatch.solve_batched(a_s, b_s, backend="auto"), mesh,
                  axes)
    _check(torch.equal(x_sh, x_ref), "the sharded solve is not bitwise the "
           "unsharded one")
    a_loc, b_loc = shard(a_s, mesh, axes), shard(b_s, mesh, axes)
    with f32_matmuls():
        r = a_loc @ x_sh[..., None] - b_loc[..., None]
    fig["sharded_resid"] = float(r.norm() / b_loc.norm())
    _check(fig["sharded_resid"] < 1e-4, fig["sharded_resid"])
    if dp > 1:
        try:
            BatchedSolver(mesh=mesh).solve(a_s[:Bs - 1], b_s[:Bs - 1])
        except ValueError:
            pass
        else:
            raise AssertionError("an indivisible batch was not refused")

    # the distributed single-matrix LU, its comm against the model
    n_big = 8 * tp
    g = _gen(7)
    a_big = (torch.randn(n_big, n_big, generator=g)
             + 3.0 * n_big ** 0.5 * torch.eye(n_big)).to(dev)
    b_big = torch.ones(n_big, device=dev)
    with comm.CommMeter() as meter:
        x = distributed_solve(a_big, b_big, mesh, axis="tp", nb=4)
    model = comm.model_lu_solve(n_big, 4, k_rhs=1)
    _check(meter.as_dict() == model, meter.as_dict())
    fig["dist_lu_resid"] = float(
        (a_big.double() @ x.double() - 1).norm() / b_big.norm())
    _check(fig["dist_lu_resid"] < 1e-4, fig["dist_lu_resid"])

    # the tall factorizations, row-sharded over dp
    M, n_sm = 8 * dp, 4
    g = _gen(11)
    a_tall = torch.randn(M, n_sm, generator=g).to(dev)
    b_tall = torch.randn(M, generator=g).to(dev)
    x_ls = distributed_lstsq(a_tall, b_tall, mesh, axis="dp")
    opt = float((a_tall.double().T @ (a_tall.double() @ x_ls.double()
                                      - b_tall.double())).norm())
    _check(opt < 1e-4, opt)
    svd = distributed_svd_tall(a_tall, mesh, axis="dp")
    a_rows = shard(a_tall, mesh, "dp")
    fig["dist_svd_err"] = float(comm.pmax(
        ((svd.U * svd.s[None, :]) @ svd.V.T - a_rows).abs().amax(),
        mesh.get_group("dp")))
    _check(fig["dist_svd_err"] < 1e-3, fig["dist_svd_err"])

    # row-sharded CG, one all-gather a matvec
    n_cg = 8 * dp
    g = _gen(17)
    g_cg = torch.randn(n_cg, n_cg, generator=g)
    a_cg = (g_cg @ g_cg.T / n_cg + 4.0 * torch.eye(n_cg)).to(dev)
    cg = distributed_cg(a_cg, torch.ones(n_cg, device=dev), mesh,
                        axis="dp", tol=1e-5)
    _check(bool(cg.converged), float(cg.resnorm))

    # the float64-class refinement over the distributed factor
    dd = distributed_solve_dd(a_big, b_big, mesh, axis="tp", nb=4)
    _check(bool(dd.ok), float(dd.resid))
    _check(float(dd.resid) < 1e-8, float(dd.resid))
    fig["dd_resid"] = float(dd.resid)

    # block-Jacobi eigh over a ring of the dp ranks: comm = the adaptive
    # model at the sweeps it ran
    n_e = 4 * (2 * dp)
    g = _gen(13)
    g_e = torch.randn(n_e, n_e, generator=g)
    a_sym = ((g_e + g_e.T) / 2.0).to(dev)
    with comm.CommMeter() as meter:
        eres = distributed_eigh(a_sym, mesh, axis="dp", sweeps=8)
    k_used = int(eres.sweeps_used)
    w_e = n_e // (2 * dp)
    emodel = comm.model_eigh_adaptive(n_e, dp, w_e, k_used)
    _check(meter.as_dict() == emodel, (meter.as_dict(), emodel))
    _check(1 <= k_used < 8, k_used)
    _check(bool(eres.converged), float(eres.offnorm))
    cols = 2 * w_e * axis_index(mesh, "dp")
    w_loc = eres.w[cols:cols + 2 * w_e]
    with f32_matmuls():
        eig_err = float((a_sym @ eres.V - eres.V * w_loc[None, :]).abs().amax())
    anorm = float(torch.linalg.matrix_norm(a_sym.double(), 2))
    _check(eig_err < 2e-5 * max(anorm, 1.0), (eig_err, anorm))
    fig["eigh_sweeps"] = k_used

    # weak scaling: fixed columns a rank, a growing axis; the same program
    # at every size, its collectives equal to the model at each
    nb_ws, per_dev = 2, 4
    for D in (2, 4, 8, 16):
        if D > n_devices:
            break
        ws_mesh = make_mesh(dp=1, tp=D, device_type=dev.type)
        if ws_mesh.get_coordinate() is None:
            continue
        n_ws = per_dev * nb_ws * D
        g = _gen(100 + D)
        a_ws = (torch.randn(n_ws, n_ws, generator=g)
                + 3.0 * n_ws ** 0.5 * torch.eye(n_ws)).to(dev)
        with comm.CommMeter() as meter:
            x_ws = distributed_solve(a_ws, torch.ones(n_ws, device=dev),
                                     ws_mesh, axis="tp", nb=nb_ws)
        _check(meter.as_dict() == comm.model_lu_solve(n_ws, nb_ws),
               (D, meter.as_dict()))
        r_ws = float((a_ws.double() @ x_ws.double() - 1).norm() / n_ws ** 0.5)
        _check(r_ws < 1e-4, (D, r_ws))

    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh={{'dp': {dp}, 'tp': {tp}}}, "
              f"loss={fig['loss']:.4f}, "
              f"dist_lu_resid={fig['dist_lu_resid']:.2e}, "
              f"dist_svd_err={fig['dist_svd_err']:.2e}, "
              f"dd_resid={fig['dd_resid']:.2e}, "
              f"eigh_sweeps={k_used}, "
              f"sharded_resid={fig['sharded_resid']:.2e}",
              flush=True)
    return fig


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", tuple(out.shape))
