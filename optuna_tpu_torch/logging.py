"""Library-wide logging management.

Parity target: ``optuna/logging.py:31-343`` (root-logger management,
``set_verbosity``, propagation toggles). Color output is enabled when the
stream is a TTY, without depending on ``colorlog``.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from logging import CRITICAL  # noqa: F401
from logging import DEBUG  # noqa: F401
from logging import ERROR  # noqa: F401
from logging import FATAL  # noqa: F401
from logging import INFO  # noqa: F401
from logging import WARN  # noqa: F401
from logging import WARNING  # noqa: F401


_lock = threading.Lock()
_default_handler: logging.Handler | None = None

_COLORS = {
    logging.DEBUG: "\033[36m",  # cyan
    logging.INFO: "\033[32m",  # green
    logging.WARNING: "\033[33m",  # yellow
    logging.ERROR: "\033[31m",  # red
    logging.CRITICAL: "\033[41m",  # red background
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool) -> None:
        super().__init__("[%(levelname)1.1s %(asctime)s,%(msecs)03d] %(message)s", "%Y-%m-%d %H:%M:%S")
        self._use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        out = super().format(record)
        if self._use_color:
            color = _COLORS.get(record.levelno, "")
            if color:
                out = f"{color}{out}{_RESET}"
        return out


def create_default_formatter() -> logging.Formatter:
    """The library's default log formatter, color-aware exactly when the
    default handler would be (reference ``logging.py:31``) — public so users
    can mirror the format on their own handlers."""
    use_color = hasattr(sys.stderr, "isatty") and sys.stderr.isatty() and os.name != "nt"
    return _ColorFormatter(use_color)


def _get_library_name() -> str:
    return __name__.split(".")[0]


def _get_library_root_logger() -> logging.Logger:
    return logging.getLogger(_get_library_name())


def _configure_library_root_logger() -> None:
    global _default_handler
    with _lock:
        if _default_handler is not None:
            return
        _default_handler = logging.StreamHandler()
        use_color = hasattr(sys.stderr, "isatty") and sys.stderr.isatty() and os.name != "nt"
        _default_handler.setFormatter(_ColorFormatter(use_color))
        root = _get_library_root_logger()
        root.addHandler(_default_handler)
        root.setLevel(logging.INFO)
        root.propagate = False


def get_logger(name: str) -> logging.Logger:
    """Return a logger under the library root, initializing handlers once."""
    _configure_library_root_logger()
    return logging.getLogger(name)


def get_verbosity() -> int:
    _configure_library_root_logger()
    return _get_library_root_logger().getEffectiveLevel()


def set_verbosity(verbosity: int) -> None:
    _configure_library_root_logger()
    _get_library_root_logger().setLevel(verbosity)


def disable_default_handler() -> None:
    _configure_library_root_logger()
    assert _default_handler is not None
    _get_library_root_logger().removeHandler(_default_handler)


def enable_default_handler() -> None:
    _configure_library_root_logger()
    assert _default_handler is not None
    _get_library_root_logger().addHandler(_default_handler)


def disable_propagation() -> None:
    _configure_library_root_logger()
    _get_library_root_logger().propagate = False


def enable_propagation() -> None:
    _configure_library_root_logger()
    _get_library_root_logger().propagate = True


_warn_once_lock = threading.Lock()
_warned_once_keys: set[tuple[str, str]] = set()


def warn_once(logger: logging.Logger, key: str, message: str) -> bool:
    """Emit ``message`` at WARNING level the first time ``key`` is seen on
    this logger (per process); later calls are silent no-ops. Returns True
    when the warning was actually emitted.

    The shared copy of the hand-rolled suppress-repeat-warnings logic the
    resilience layers grew independently (``GuardedSampler`` warned once per
    study, the batch executor once per degradation condition): repeated
    containment events are *recorded* — telemetry counters and trial attrs
    carry every occurrence — but warned about once, so a study degrading a
    thousand trials does not bury its log. Keys should carry whatever
    identity bounds the suppression (study id, executor token, phase).
    """
    with _warn_once_lock:
        dedupe_key = (logger.name, key)
        if dedupe_key in _warned_once_keys:
            return False
        _warned_once_keys.add(dedupe_key)
    logger.warning(message)
    return True


def reset_warn_once() -> None:
    """Forget every ``warn_once`` key (tests; a long-lived service rotating
    studies may also call it to re-arm the one-shot warnings)."""
    with _warn_once_lock:
        _warned_once_keys.clear()
