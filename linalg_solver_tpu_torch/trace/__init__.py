"""Device-event → LaTeX trace replay layer (counterpart of
``linalg_solver_tpu.trace``)."""

from .events import (
    log_replayed_reduction,
    replay_matches_exact,
    replay_rref_events,
    replay_solve_trace,
)

__all__ = [
    "replay_rref_events",
    "log_replayed_reduction",
    "replay_matches_exact",
    "replay_solve_trace",
]
