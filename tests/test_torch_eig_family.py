"""``chip_smoke.py``'s eigenvector-family block (phases 36-45) on the CPU:
its host figures and limits, driven through the port and through the JAX
package, which have the same API, on the same seeded inputs at a small
size.

Run as a script, it gives the JAX package's figures on the card's own
inputs at full width (``--lanes`` lanes of the 32; the polynomials and
the Jordan lane always), the figures ``chip_smoke.EIGF_JAX`` records
where the JAX package misses a limit:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_eig_family.py \\
        --lanes 8 [--cells eig-cond-256,sign-256]
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

SMALL = {"bsz": 2, "n": 16, "roots_b": 8, "ric_n": 8, "quad_n": 8}


def _lib(a):
    return np.linalg.eigvals(a.astype(np.float64))


def jax_family(x, cells=None):
    """The JAX package's host results and figures on the inputs ``x``."""
    import jax.numpy as jnp

    from linalg_solver_tpu import ops

    return chip_smoke.run_family(ops, x, jnp.asarray, _lib, cells=cells)


def torch_family(x, cells=None):
    """The port's on the CPU (its plain versions)."""
    import torch

    from linalg_solver_tpu_torch import ops

    return chip_smoke.run_family(ops, x, torch.from_numpy, _lib, cells=cells)


@pytest.fixture(scope="module")
def small():
    return chip_smoke.eigf_inputs(**SMALL)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_family_figures_hold_at_small_size(small, package):
    out, figs = (jax_family if package == "jax" else torch_family)(small)
    chip_smoke.hold_family(figs, bsz=SMALL["bsz"])
    assert figs["eig-256"][1]["valid"] == SMALL["bsz"] * SMALL["n"]
    assert figs["geig-256"]["not_finite"] == {0: chip_smoke.GSHIFT_INF}
    assert figs["stein-256"]["not_ok"] == [chip_smoke.STEIN_BAD_LANE]
    assert set(out) >= {"eig0", "eig1", "cond", "roots", "sign", "count",
                        "projector", "sylvester", "lyapunov", "stein",
                        "care", "dare", "geigh", "geig", "gshift", "quad"}


def test_family_lanes_keep_the_special_lanes(small):
    x = chip_smoke.eigf_lanes(small, 1)
    assert x["cond"].shape[0] == 2
    np.testing.assert_array_equal(x["cond"][1], small["cond"][-1])
    assert x["roots"].shape == small["roots"].shape
    assert all(t.shape[0] == 1 for t in x["sylvester"])
    # the Jordan lane's trace: 16 x 0.5 and the rest evenly in [2, 6]
    n = SMALL["n"]
    rest = 2.0 + 4.0 * np.arange(n - 16) / max(n - 17, 1)
    assert np.trace(small["cond"][-1].astype(np.float64)) == pytest.approx(
        8.0 + rest.sum(), abs=1e-4)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--cells", default="",
                    help="comma-separated cells (default: all)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    x = chip_smoke.eigf_lanes(chip_smoke.eigf_inputs(), args.lanes)
    t0 = time.perf_counter()
    _, figs = jax_family(x, args.cells.split(",") if args.cells else None)
    figs["seconds"] = time.perf_counter() - t0
    figs["lanes"] = args.lanes
    print(json.dumps(figs, indent=1))


if __name__ == "__main__":
    main()
