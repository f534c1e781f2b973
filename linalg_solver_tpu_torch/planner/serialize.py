"""Process-plan serialization.

A ``Process`` tree is a complete, executable description of a determinant
computation — the framework's checkpointable *plan* artifact (the closest
analog in the reference is the Rust ``Process`` tree, SURVEY.md §5
"Checkpoint / resume").  This module round-trips plans through the same
JSON schema the C++ native planner emits, so plans can be persisted,
shipped across processes, or produced by one engine and executed later.
"""

from __future__ import annotations

import json
from typing import Tuple

from ..exact.permutation import Permutation
from .process import (
    AddRow,
    BlockTriangular,
    ColExpansion,
    Cost,
    Direct,
    Nonzeros,
    Process,
    RowExpansion,
)


def process_to_dict(process: Process) -> dict:
    raw = process.raw
    nz = [[r, c] for r, c in process.expected_nonzeros.entries()]
    if isinstance(raw, Direct):
        return {"kind": "Direct", "size": raw.size, "nz": nz}
    if isinstance(raw, RowExpansion):
        return {
            "kind": "RowExpansion",
            "row": raw.row,
            "minors": [[c, process_to_dict(sub)] for c, sub in raw.minors],
            "nz": nz,
        }
    if isinstance(raw, ColExpansion):
        return {
            "kind": "ColExpansion",
            "col": raw.col,
            "minors": [[r, process_to_dict(sub)] for r, sub in raw.minors],
            "nz": nz,
        }
    if isinstance(raw, BlockTriangular):
        return {
            "kind": "BlockTriangular",
            "row_perm": raw.row_perm.perm,
            "col_perm": raw.col_perm.perm,
            "blocks": [process_to_dict(b) for b in raw.blocks],
            "nz": nz,
        }
    if isinstance(raw, AddRow):
        return {
            "kind": "AddRow",
            "src": raw.src,
            "dst": raw.dst,
            "pivot_col": raw.pivot_col,
            "result": process_to_dict(raw.result),
            "nz": nz,
        }
    raise TypeError(f"Unknown process variant: {raw!r}")


def process_from_dict(node: dict, size_hint: int) -> Process:
    # Shares the schema with the native engine's emitter; reuse its parser.
    from .native import _parse_process

    return _parse_process(node, size_hint)


def dumps_plan(cost: Cost, process: Process) -> str:
    """Serialize a planned strategy (cost + process tree) to JSON."""
    return json.dumps(
        {
            "cost": {
                "mults": cost.multiplications,
                "adds": cost.additions,
            },
            "process": process_to_dict(process),
        }
    )


def loads_plan(text: str) -> Tuple[Cost, Process]:
    obj = json.loads(text)
    cost = Cost(obj["cost"]["mults"], obj["cost"]["adds"])
    process = process_from_dict(
        obj["process"], _top_size(obj["process"])
    )
    return cost, process


def _top_size(node: dict) -> int:
    from .native import _node_size

    return _node_size(node)
