"""``chip_smoke.py``'s block of ordered Schur forms, pseudospectra, matrix
functions, nearness and fitting (phases 46-52) on the CPU: its host
figures and limits, driven through the port and through the JAX package,
which have the same API, on the same seeded inputs at a small size.

Run as a script, it gives the JAX package's figures on the card's own
inputs at full width (``--lanes`` lanes of each batch), the figures
``chip_smoke.MF_JAX`` records where the JAX package misses a limit:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_matfun.py \\
        --lanes 4 [--cells funm-256,pseudo-128]
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

SMALL = {"bsz": 2, "n": 16, "ps_b": 2, "ps_n": 12, "fn_b": 2, "fn_n": 12,
         "near_b": 2, "near_n": 12, "fit_b": 2, "fit_m": 36, "fit_n": 12}
LANES = {k: SMALL[k] for k in ("bsz", "ps_b", "fn_b", "near_b", "fit_b")}


def jax_matfun(x, cells=None):
    """The JAX package's host results and figures on the inputs ``x``."""
    import jax
    import jax.numpy as jnp

    from linalg_solver_tpu import ops

    def grad(fn, a, g):
        return jax.grad(lambda a_: jnp.sum(g * fn(a_)))(a)

    # the grid's start is the JAX package's own draw (PRNGKey(0))
    n = x["pseudo"].shape[-1]
    u0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                      (2, chip_smoke.PS_G ** 2, n),
                                      jnp.float32))
    x = dict(x, ps_u0=(u0[0], u0[1]))
    return chip_smoke.run_matfun(ops, x, jnp.asarray, grad, jnp.exp,
                                 cells=cells, pass_u0=False)


def torch_matfun(x, cells=None):
    """The port's on the CPU (its plain versions)."""
    import torch

    from linalg_solver_tpu_torch import ops

    return chip_smoke.run_matfun(ops, x, torch.from_numpy,
                                 chip_smoke.torch_grad, torch.exp,
                                 cells=cells)


@pytest.fixture(scope="module")
def small():
    return chip_smoke.mf_inputs(**SMALL)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_block_figures_hold_at_small_size(small, package):
    out, figs = (jax_matfun if package == "jax" else torch_matfun)(small)
    chip_smoke.hold_matfun(figs, **LANES)
    assert set(figs) == {"ordschur-256", "cluster-cond-256", "pseudo-128",
                         "funm-128", "expm-256", "funm-256", "frechet-128",
                         "nearness-128", "fitting-768x256"}
    assert figs["pseudo-128"]["shape"] == [2, chip_smoke.PS_G,
                                           chip_smoke.PS_G]
    assert set(out) >= {"schur", "rsf2csf", "reorder", "sort", "invariant",
                        "cluster_cond", "pseudo", "pseudo_schur", "sqrtm", "logm", "powm",
                        "expm", "expm_grad", "funm", "frechet", "expm_cond",
                        "ncorr", "npsd", "north", "ridge", "tls",
                        "procrustes", "angles"}


def test_hold_refuses_a_missed_limit(small):
    _, figs = torch_matfun(small, cells=["funm-128"])
    figs["funm-128"]["sqrtm"] = 2 * chip_smoke.MF_LIMITS["sqrtm"]
    with pytest.raises(AssertionError, match="sqrtm"):
        chip_smoke.hold_matfun(figs, **LANES)


def test_lanes_keep_the_grid_and_points(small):
    x = chip_smoke.mf_lanes(small, 1)
    assert x["ord"].shape[0] == 1 and x["near"].shape[0] == 1
    assert all(t.shape[0] == 1 for t in x["fit"])
    assert x["grid"][0].shape == (chip_smoke.PS_G,)
    assert all(u.shape == (chip_smoke.PS_G ** 2, 12) for u in x["ps_u0"])
    assert (x["points"][:, 0] == 0).all()
    np.testing.assert_array_equal(x["points"][:, 1:], small["points"][:, 1:])


def test_trsyl_work_counts_the_block():
    import torch

    t = torch.zeros(2, 8, 8)
    nbytes, ops = chip_smoke.trsyl_work(t, torch.tensor([0, 3]), 4)
    # lane 0 has no block: only T's triangle is read
    assert nbytes == (2 * 8 * 9 + 4 * 15) * 4
    assert ops == 8 * 5 * 3 + 8 * 3 * 10 + 12 * 15


@pytest.mark.parametrize("module", ["ordschur", "pseudospectra", "funm",
                                    "nearness", "fitting"])
def test_ops_exports(module):
    """Every name the JAX package's ``ops`` exports from the module is in
    the port's ``ops`` too, with the same fields where it is a result
    type."""
    import importlib

    jops = importlib.import_module("linalg_solver_tpu.ops")
    tops = importlib.import_module("linalg_solver_tpu_torch.ops")
    jmod = f"linalg_solver_tpu.ops.{module}"
    names = [n for n in jops.__all__
             if getattr(getattr(jops, n, None), "__module__", "") == jmod]
    assert len(names) >= 3
    for name in names:
        assert name in tops.__all__
        got = getattr(tops, name)
        assert got.__module__ == f"linalg_solver_tpu_torch.ops.{module}"
        ref = getattr(jops, name)
        if hasattr(ref, "_fields"):
            assert got._fields == ref._fields


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--cells", default="",
                    help="comma-separated cells (default: all)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    x = chip_smoke.mf_lanes(chip_smoke.mf_inputs(), args.lanes)
    t0 = time.perf_counter()
    _, figs = jax_matfun(x, args.cells.split(",") if args.cells else None)
    figs["seconds"] = time.perf_counter() - t0
    figs["lanes"] = args.lanes
    print(json.dumps(figs, indent=1))


if __name__ == "__main__":
    main()
