"""The port's checkpoints (``linalg_solver_tpu_torch.utils.checkpoint``):
a plan file written by the JAX package's ``save_plan`` loads in the port
and serializes back to the same JSON; a tree of tensors round-trips
through ``save_pytree`` / ``load_pytree`` bit for bit, its structure
from ``like``."""

from typing import NamedTuple

import pytest
import torch

import linalg_solver_tpu.planner as jplan
from linalg_solver_tpu.utils import checkpoint as jck
from linalg_solver_tpu_torch.planner.serialize import dumps_plan
from linalg_solver_tpu_torch.utils import checkpoint as tck

from torch_text_cases import pattern


def test_jax_plan_file_loads_in_the_port(tmp_path):
    p = pattern([[1, 2, 0, 0], [3, 4, 5, 0], [0, 6, 7, 8], [0, 0, 9, 1]])
    r = jplan.find_optimal_determinant_process(p)
    path = tmp_path / "plan.json"
    jck.save_plan(str(path), r.cost, r.process)
    cost, proc = tck.load_plan(str(path))
    assert dumps_plan(cost, proc) == path.read_text(encoding="utf-8")
    again = tmp_path / "again.json"
    tck.save_plan(str(again), cost, proc)
    assert again.read_text(encoding="utf-8") == path.read_text(
        encoding="utf-8")


class _State(NamedTuple):
    w: torch.Tensor
    step: torch.Tensor


def test_pytree_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": [torch.randn(3, 4, generator=g),
                       (torch.randn(2, generator=g, dtype=torch.float64),)],
            "state": _State(torch.randn(5, generator=g),
                            torch.tensor(7, dtype=torch.int32))}
    path = tmp_path / "tree.pt"
    tck.save_pytree(str(path), tree)
    like = {"params": [torch.zeros(3, 4), (torch.zeros(2,
                                                       dtype=torch.float64),)],
            "state": _State(torch.zeros(5),
                            torch.zeros((), dtype=torch.int32))}
    out = tck.load_pytree(str(path), like)
    assert isinstance(out["state"], _State)
    assert isinstance(out["params"][1], tuple)
    for got, want in ((out["params"][0], tree["params"][0]),
                      (out["params"][1][0], tree["params"][1][0]),
                      (out["state"].w, tree["state"].w),
                      (out["state"].step, tree["state"].step)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="shape"):
        tck.load_pytree(str(path), {**like, "params": [torch.zeros(4, 3),
                                                       like["params"][1]]})
    with pytest.raises(ValueError, match="more leaves"):
        tck.load_pytree(str(path), {"params": like["params"]})
