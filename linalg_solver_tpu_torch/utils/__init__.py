"""Utilities for the port: matmul precision control, CUDA timing, and the
exact path's LaTeX layer (``fmt``) and trace logger (``trace``)."""

from .fmt import (
    cformat,
    latex_scalar,
    linear_comb,
    make_latex_augmented_matrix,
    make_latex_matrix,
    make_latex_vector,
    make_latex_vertical_augmented_matrix,
    multi_add,
    multi_add_vargs,
    multi_mul,
    pcformat,
    pretty_print_arithmetic,
    prod,
    scalar_mul,
)
from .trace import (
    Logger,
    TraceStack,
    capture_logs,
    current_logger,
    global_logger,
    ignore_log,
    log,
    nest_appending_logger,
    nest_logger,
    pop_logger,
    push_logger,
    raw_log,
)

__all__ = [
    "cformat", "latex_scalar", "pcformat", "pretty_print_arithmetic",
    "make_latex_matrix", "make_latex_vector", "make_latex_augmented_matrix",
    "make_latex_vertical_augmented_matrix",
    "multi_add", "multi_add_vargs", "multi_mul", "prod", "scalar_mul",
    "linear_comb",
    "Logger", "TraceStack", "global_logger", "current_logger",
    "push_logger", "pop_logger", "log", "raw_log",
    "nest_logger", "nest_appending_logger", "ignore_log", "capture_logs",
]
