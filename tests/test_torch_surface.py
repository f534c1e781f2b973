"""The port's package surface against the JAX package's: ``ops.__all__``
has the same names, each resolving to an object defined in the port's
counterpart of the JAX package's defining module (``ops.solve_batched``
is ``ops.solve``'s loop there and here, not ``dispatch``'s); the event
codes are equal; ``utils.__all__`` covers the JAX package's;
``models.__all__`` lacks none of the JAX package's names
(``DELIBERATELY_ABSENT`` is empty since the mesh layer was ported); and
``parallel.__all__`` is the JAX package's, each name from the port's
counterpart of its defining module."""

import importlib

import pytest
import torch

import linalg_solver_tpu.models as jmodels
import linalg_solver_tpu.ops as jops
import linalg_solver_tpu.parallel as jparallel
import linalg_solver_tpu.utils as jutils
import linalg_solver_tpu_torch.models as models
import linalg_solver_tpu_torch.ops as ops
import linalg_solver_tpu_torch.parallel as parallel
import linalg_solver_tpu_torch.utils as utils

#: JAX-package names of ``models`` the port leaves out on purpose: none
DELIBERATELY_ABSENT = set()


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


def test_parallel_names_and_their_modules():
    assert parallel.__all__ == jparallel.__all__
    for name in jparallel.__all__:
        got, want = getattr(parallel, name), getattr(jparallel, name)
        assert got.__module__ == _port_module(want.__module__), name


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
