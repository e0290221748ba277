"""Profiler tracing hooks (port of ``optuna_tpu/_tracing.py``).

Wraps ``torch.profiler`` so a study run can be captured for Perfetto or
TensorBoard with no change to the objective:

* :func:`trace` — context manager that runs a ``torch.profiler.profile``
  over the enclosed block (the CPU and, when there is a card, CUDA
  activities) and writes its Chrome trace into ``logdir``.
* :func:`annotate` — a named ``torch.profiler.record_function`` range; the
  optimize loops wrap each trial's ask/objective/tell in one, so kernels
  line up with trial numbers on the timeline.
* ``OPTUNA_TPU_TORCH_TRACE=<logdir>`` — environment switch that traces every
  ``Study.optimize`` / ``optimize_scan`` / ``optimize_vectorized`` call
  without touching user code.

While no profiler runs (neither :func:`trace` nor a caller's own
``torch.profiler.profile``), :func:`annotate` returns one shared null
context: two checks and no allocation on the hot path.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from optuna_tpu_torch.logging import get_logger

_logger = get_logger(__name__)

_active = False
#: The trace file the last :func:`trace` wrote.
last_trace_path: str | None = None


def is_tracing() -> bool:
    return _active


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write its Chrome trace to
    ``logdir/optuna_tpu_torch-<pid>-<ms>.pt.trace.json`` (open it in
    Perfetto or ``chrome://tracing``). Yields the profiler, whose
    ``key_averages()`` and ``events()`` stay readable after the block."""
    global _active, last_trace_path
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"optuna_tpu_torch-{os.getpid()}-{int(time.time() * 1e3)}.pt.trace.json")
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _active = True
    _logger.info(f"torch profiler trace started -> {logdir}")
    try:
        yield prof
    finally:
        _active = False
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        last_trace_path = path
        _logger.info(f"torch profiler trace written to {path}")


@contextlib.contextmanager
def maybe_trace_from_env() -> Iterator[None]:
    """Honor ``OPTUNA_TPU_TORCH_TRACE=<logdir>``: the optimize loops wrap
    their run in this, so any run can be profiled from the environment
    alone. Nested optimize calls (or an already-active :func:`trace`) do
    not start a second profiler."""
    logdir = os.environ.get("OPTUNA_TPU_TORCH_TRACE")
    if not logdir or _active:
        yield
        return
    with trace(logdir):
        yield


# One shared no-op context for the idle path: ``nullcontext()`` is
# reentrant and stateless, so a singleton costs no allocation per trial.
_NULL_ANNOTATION = contextlib.nullcontext()


def annotate(name, lazy_arg=None):
    """A named profiler range while a profiler runs, else a no-op.

    ``name`` may be lazy so the idle path never formats a string:

    * a plain ``str`` — used as-is;
    * a zero-arg callable — called only when a profiler runs;
    * a ``(fmt, args)`` tuple — ``fmt % args``, formatted only then;
    * a ``%``-format ``str`` plus ``lazy_arg`` — the allocation-free spelling
      for per-trial names (``annotate("optuna_tpu_torch.trial.%d",
      trial.number)``).
    """
    if not _active and not torch.autograd._profiler_enabled():
        return _NULL_ANNOTATION
    if callable(name):
        name = name()
    elif isinstance(name, tuple):
        fmt, args = name
        name = fmt % args
    elif lazy_arg is not None:
        name = name % lazy_arg
    return torch.profiler.record_function(name)
