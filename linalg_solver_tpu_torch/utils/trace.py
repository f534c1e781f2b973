"""Hierarchical trace logger: the composability backbone of the exact path
(counterpart of ``linalg_solver_tpu.utils.trace``).

Every operation in the exact (host) path writes LaTeX lines into the logger
at the top of a module-level stack.  Context managers create isolated or
deferred scopes so that sub-derivations can be captured and re-emitted as a
contiguous block after their parent line — which is what makes composed
computations read well in the final document.  ``trace.events`` feeds the
device-recorded pivot events of ``ops.rref`` back into the same trace.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .fmt import pcformat


class Logger:
    """Accumulates formatted LaTeX lines.

    ``level_limit`` filters out messages logged with a level above it.
    ``auto_print`` additionally echoes each accepted line to stdout.
    """

    __slots__ = ("accum", "level_limit", "auto_print")

    # Class-level default, so ``Logger._auto_print = True`` turns echoing on
    # for every logger that has no setting of its own.
    _auto_print: bool = False

    def __init__(self, accum: Optional[List[str]] = None, level_limit: int = 0,
                 auto_print: Optional[bool] = None):
        self.accum: List[str] = accum if accum is not None else []
        self.level_limit = level_limit
        self.auto_print = auto_print

    def log(self, message: str, level: int = 0) -> None:
        if level > self.level_limit:
            return
        self.accum.append(message)
        echo = self.auto_print if self.auto_print is not None else Logger._auto_print
        if echo:
            print(message)

    def __str__(self) -> str:
        return "\n".join(self.accum)

    def __len__(self) -> int:
        return len(self.accum)


class TraceStack:
    """A stack of loggers; ``log`` always writes to the top."""

    def __init__(self) -> None:
        self._stack: List[Logger] = []

    @property
    def top(self) -> Logger:
        if not self._stack:
            raise ValueError("Trace stack is empty")
        return self._stack[-1]

    def push(self, logger: Optional[Logger] = None) -> Logger:
        logger = logger if logger is not None else Logger()
        self._stack.append(logger)
        return logger

    def pop(self) -> Logger:
        if not self._stack:
            raise ValueError("No logger to pop")
        return self._stack.pop()

    def depth(self) -> int:
        return len(self._stack)


#: The process-wide trace stack.  A global auto-printing logger sits at the
#: bottom so that top-level computations are visible immediately.
_TRACE = TraceStack()
global_logger = Logger()
global_logger.auto_print = True
_TRACE.push(global_logger)


def current_logger() -> Logger:
    return _TRACE.top


def push_logger(logger: Optional[Logger] = None) -> Logger:
    return _TRACE.push(logger)


def pop_logger() -> Logger:
    return _TRACE.pop()


def raw_log(message: str) -> None:
    """Append a pre-formatted line to the current logger."""
    _TRACE.top.log(message)


def log(message: str, *args) -> None:
    """Format ``message`` (``%s`` placeholders, values cformat-ted) and log it."""
    raw_log(pcformat(message, *args))


class _ScopeGuard:
    """Context manager that pushes a fresh logger and optionally forwards the
    captured text to an accumulator list when the scope closes."""

    def __init__(self, logger: Optional[Logger] = None,
                 append_to: Optional[List[str]] = None):
        self.logger = logger
        self.append_to = append_to

    def __enter__(self) -> Logger:
        self.logger = push_logger(self.logger)
        return self.logger

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        captured = pop_logger()
        if self.append_to is not None and len(captured) > 0:
            self.append_to.append(str(captured))
        return False


def nest_logger() -> _ScopeGuard:
    """Run a block with an isolated logger; its text is available via the
    context value and discarded unless the caller keeps a reference."""
    return _ScopeGuard()


def nest_appending_logger(logs_list: List[str]) -> _ScopeGuard:
    """Run a block with an isolated logger; on exit, its text (if any) is
    appended as one string to ``logs_list`` for deferred emission."""
    return _ScopeGuard(append_to=logs_list)


def ignore_log(f: Callable):
    """Run ``f`` with logging suppressed; return its result."""
    with nest_logger():
        return f()


def capture_logs(f: Callable) -> str:
    """Run ``f`` with a fresh logger and return everything it logged."""
    with nest_logger() as lg:
        f()
    return str(lg)
