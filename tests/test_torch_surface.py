"""The port's package surface against the JAX package's: ``ops.__all__``
has the same names, each resolving to an object defined in the port's
counterpart of the JAX package's defining module (``ops.solve_batched``
is ``ops.solve``'s loop there and here, not ``dispatch``'s); the event
codes are equal; ``utils.__all__`` covers the JAX package's; and the only
names of ``models.__all__`` the port lacks are the ones that need a
device mesh (``DELIBERATELY_ABSENT``, ROADMAP queue 1 item 13)."""

import importlib

import pytest
import torch

import linalg_solver_tpu.models as jmodels
import linalg_solver_tpu.ops as jops
import linalg_solver_tpu.utils as jutils
import linalg_solver_tpu_torch.models as models
import linalg_solver_tpu_torch.ops as ops
import linalg_solver_tpu_torch.utils as utils

#: JAX-package names the port leaves out on purpose: the training step
#: over a mesh of devices (one H100 is the port's target)
DELIBERATELY_ABSENT = {"TrainState", "init_train_state", "make_training_step"}


def _port_module(name: str) -> str:
    return name.replace("linalg_solver_tpu.", "linalg_solver_tpu_torch.", 1)


def test_ops_names_and_their_modules():
    assert len(jops.__all__) == 195
    assert set(ops.__all__) == set(jops.__all__)
    for name in jops.__all__:
        got, want = getattr(ops, name), getattr(jops, name)
        module = getattr(want, "__module__", None)
        if module is None:          # the event codes and their names
            assert got == want, name
            continue
        assert got.__module__ == _port_module(module), name
    solve = importlib.import_module("linalg_solver_tpu_torch.ops.solve")
    for name in ("solve_batched", "inverse_batched", "rank_batched",
                 "nullspace_batched"):
        assert getattr(ops, name) is getattr(solve, name)


def test_utils_and_models_surface():
    assert set(jutils.__all__) <= set(utils.__all__)
    for name in utils.__all__:
        assert hasattr(utils, name), name
    missing = set(jmodels.__all__) - set(models.__all__)
    assert missing == DELIBERATELY_ABSENT
    for name in models.__all__:
        assert hasattr(models, name), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            utils.chained_time(lambda x: x, torch.zeros(2))
        with pytest.raises(RuntimeError, match="CUDA"):
            with utils.profiler_trace("unused"):
                pass
