"""Checkpoint and resume (counterpart of
``linalg_solver_tpu.utils.checkpoint``).

Two durable artifacts, as in the reference:

- **Trees of tensors** (nested dicts, lists, tuples and NamedTuples of
  tensors, such as a solver's state) via ``torch.save`` and
  ``torch.load(weights_only=True)``, where the reference uses Orbax.  The
  file holds the leaves only; ``load_pytree``'s ``like`` gives the
  structure back, as the reference's ``target``, so no class is pickled.
- **Computation plans** (planner ``Process`` trees) via
  ``planner.serialize``: a plan computed once can be stored and executed
  again on new values.  The JSON is the reference's, so a plan file the
  JAX package wrote loads here.
"""

from __future__ import annotations

import os
from typing import Any, List

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, out: List) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            _flatten(item, out)
    else:
        out.append(tree)


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    leaf = next(leaves)
    if isinstance(like, torch.Tensor):
        if tuple(leaf.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(leaf.shape)} "
                             f"where the structure has {tuple(like.shape)}")
        return leaf.to(device=like.device, dtype=like.dtype)
    return leaf


def save_pytree(path: str, tree: Any) -> None:
    """Save the leaves of a tree of tensors (dicts, lists, tuples,
    NamedTuples; dict entries in sorted key order) to the file ``path``;
    tensors are saved from the CPU."""
    leaves: List = []
    _flatten(tree, leaves)
    leaves = [t.detach().cpu() if isinstance(t, torch.Tensor) else t
              for t in leaves]
    torch.save({"leaves": leaves}, os.path.abspath(path))


def load_pytree(path: str, like: Any) -> Any:
    """Restore a tree saved with ``save_pytree``: ``like`` gives the
    structure, and each tensor leaf's shape, dtype and device."""
    data = torch.load(os.path.abspath(path), weights_only=True)
    leaves = iter(data["leaves"])
    out = _unflatten(like, leaves)
    if next(leaves, leaves) is not leaves:
        raise ValueError("checkpoint holds more leaves than the structure")
    return out


def save_plan(path: str, cost, process) -> None:
    """Persist a planned determinant strategy (see planner.serialize)."""
    from ..planner.serialize import dumps_plan

    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps_plan(cost, process))


def load_plan(path: str):
    from ..planner.serialize import loads_plan

    with open(path, encoding="utf-8") as f:
        return loads_plan(f.read())
