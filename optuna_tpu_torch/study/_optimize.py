"""Trial-execution engine behind ``Study.optimize`` (PyTorch port of
``optuna_tpu/study/_optimize.py``).

One shared :class:`_RunBudget` hands out per-trial claims to however many
workers exist (the sequential path is one worker; ``n_jobs`` threads share
one budget), and each trial runs the ask → objective (under a heartbeat)
→ tell pipeline as an :class:`_Outcome` value. Each phase is a telemetry
span, a flight span and a profiler range (:func:`_tracing.annotate`); the
trial's ask and tell are flight events; the health reporter and the
autopilot attach at the run's entry, publish and step at every trial
boundary, and the reporter flushes its final snapshot at the run's end.

With ``n_jobs > 1`` the worker threads launch the port's kernels and torch
ops on one card, on the default stream: correct, and serial on the card.
Threads overlap only where an ask releases the GIL (host waits on the card,
NumPy), so the gain depends on the sampler.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Sequence

from optuna_tpu_torch import _tracing, autopilot, exceptions, flight, health, logging as logging_module, telemetry
from optuna_tpu_torch.progress_bar import _ProgressBar
from optuna_tpu_torch.study._tell import _tell_with_warning
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState
from optuna_tpu_torch.trial._trial import Trial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import ObjectiveFuncType, Study

_logger = logging_module.get_logger(__name__)

# The profiler range names, derived from the telemetry phase names once, so
# the per-trial hot path never builds a phase string.
_TRACE_ASK = telemetry.trace_name("ask")
_TRACE_DISPATCH = telemetry.trace_name("dispatch")
_TRACE_TELL = telemetry.trace_name("tell")
# The per-trial range: a %-format that _tracing.annotate formats only while
# a profiler runs (a timeline grouping aid outside the phase vocabulary).
_TRACE_TRIAL_FMT = "optuna_tpu_torch.trial.%d"


class _RunBudget:
    """Thread-safe accounting for one ``optimize`` call.

    Workers call :meth:`claim` before each trial; the budget says yes until
    the trial quota is spent, the wall-clock deadline passes, or the study's
    stop flag is raised. Centralising the three exit conditions here means
    the sequential and threaded paths share one definition of "done".
    """

    def __init__(self, study: "Study", n_trials: int | None, timeout: float | None) -> None:
        self._study = study
        self._quota = n_trials
        self._started = time.monotonic()
        self._deadline = None if timeout is None else self._started + timeout
        self._granted = 0
        self._halted = False
        self._mutex = threading.Lock()

    def halt(self) -> None:
        """Stop handing out claims (a worker died); peers finish their
        current trial and exit, mirroring the reference's early-abort."""
        self._halted = True

    def claim(self) -> bool:
        if self._halted or self._study._stop_flag:
            return False
        if self._deadline is not None and time.monotonic() >= self._deadline:
            return False
        with self._mutex:
            if self._quota is not None and self._granted >= self._quota:
                return False
            self._granted += 1
            return True

    def elapsed(self) -> float:
        return time.monotonic() - self._started


@dataclass
class _Outcome:
    """What happened when the objective ran: values (on success), the
    terminal state override (pruned/failed), and the error to re-raise if
    it isn't covered by ``catch``."""

    values: float | Sequence[float] | None = None
    state: TrialState | None = None
    error: BaseException | None = None
    exc_info: Any = None


def _call_objective(func: "ObjectiveFuncType", trial: Trial) -> _Outcome:
    try:
        return _Outcome(values=func(trial))
    except exceptions.TrialPruned as pruned:
        return _Outcome(state=TrialState.PRUNED, error=pruned)
    except (Exception, KeyboardInterrupt) as err:  # objective isolation: any crash becomes a FAIL tell
        return _Outcome(state=TrialState.FAIL, error=err, exc_info=sys.exc_info())


def _announce(study: "Study", frozen: FrozenTrial, outcome: _Outcome) -> None:
    """Log the trial's terminal state the way the study logger promises."""
    if frozen.state == TrialState.COMPLETE:
        study._log_completed_trial(frozen)
    elif frozen.state == TrialState.PRUNED:
        _logger.info(f"Trial {frozen.number} pruned. {outcome.error}")
    elif frozen.state == TrialState.FAIL:
        reason: Any = None
        if outcome.error is not None:
            reason = repr(outcome.error)
        elif frozen.system_attrs.get("fail_reason") is not None:
            reason = frozen.system_attrs["fail_reason"]
        if reason is not None:
            _logger.warning(
                f"Trial {frozen.number} failed with parameters: {frozen.params} "
                f"because of the following error: {reason}.",
                exc_info=outcome.exc_info,
            )
            if outcome.values is not None:
                _logger.warning(
                    f"Trial {frozen.number} failed with value {outcome.values}."
                )
    else:
        raise AssertionError(f"Unexpected trial state {frozen.state}.")


def _execute_one(
    study: "Study",
    func: "ObjectiveFuncType",
    catch: tuple[type[Exception], ...],
) -> FrozenTrial:
    """ask → objective (under a heartbeat) → tell, as one pipeline."""
    from optuna_tpu_torch.storages._heartbeat import (
        fail_stale_trials,
        get_heartbeat_thread,
        is_heartbeat_enabled,
    )

    if is_heartbeat_enabled(study._storage):
        fail_stale_trials(study)

    with _tracing.annotate(_TRACE_ASK), telemetry.span("ask"), flight.span("ask"):
        trial = study.ask()
    flight.trial_event("ask", trial.number)
    with get_heartbeat_thread(trial._trial_id, study._storage):
        with _tracing.annotate(_TRACE_TRIAL_FMT, trial.number):
            with _tracing.annotate(_TRACE_DISPATCH), telemetry.span("dispatch"), \
                    flight.span("dispatch", trial.number):
                outcome = _call_objective(func, trial)

    # Misbehaving objectives (wrong arity, NaNs, non-floats) downgrade to
    # warnings via _tell_with_warning rather than aborting the whole loop.
    try:
        with _tracing.annotate(_TRACE_TELL), telemetry.span("tell"), flight.span("tell", trial.number):
            frozen = _tell_with_warning(
                study=study,
                trial=trial,
                value_or_values=outcome.values,
                state=outcome.state,
                suppress_warning=True,
            )
    except Exception:  # announce-then-reraise: nothing is swallowed
        _announce(study, study._storage.get_trial(trial._trial_id), outcome)
        raise
    if flight.enabled():
        flight.trial_event("tell", frozen.number, frozen.state.name)
    _announce(study, frozen, outcome)

    swallowed = outcome.error is not None and isinstance(outcome.error, catch)
    if frozen.state == TrialState.FAIL and outcome.error is not None and not swallowed:
        raise outcome.error
    return frozen


def _worker(
    study: "Study",
    func: "ObjectiveFuncType",
    budget: _RunBudget,
    catch: tuple[type[Exception], ...],
    callbacks: Sequence[Callable[["Study", FrozenTrial], None]] | None,
    gc_after_trial: bool,
    progress_bar: _ProgressBar | None,
    reseed: bool,
) -> None:
    """Run trials until the shared budget refuses another claim."""
    study._thread_local.in_optimize_loop = True
    if reseed:
        study.sampler.reseed_rng()
    while budget.claim():
        # Any escape — objective error not in `catch`, a raising callback,
        # even the progress bar — halts the budget so peer workers stop
        # claiming fresh trials instead of draining the whole quota.
        try:
            try:
                frozen = _execute_one(study, func, catch)
            finally:
                # Objective locals can pin device buffers; collecting between
                # trials caps device/host memory growth.
                if gc_after_trial:
                    gc.collect()
            for callback in callbacks or ():
                callback(study, frozen)
            if progress_bar is not None:
                progress_bar.update(budget.elapsed(), study)
            # Trial-boundary health publish (rate-limited; one module-global
            # check while the reporter is off) and autopilot step (one dict
            # lookup while no control loop is attached).
            health.maybe_report(study)
            autopilot.maybe_step(study)
        except BaseException:  # halt-then-reraise: nothing is swallowed
            budget.halt()
            raise


def _optimize(
    study: "Study",
    func: "ObjectiveFuncType",
    n_trials: int | None = None,
    timeout: float | None = None,
    n_jobs: int = 1,
    catch: tuple[type[Exception], ...] = (),
    callbacks: Sequence[Callable[["Study", FrozenTrial], None]] | None = None,
    gc_after_trial: bool = False,
    show_progress_bar: bool = False,
) -> None:
    if not isinstance(catch, tuple):
        raise TypeError(
            f"The catch argument is of type '{type(catch).__name__}' but must be a tuple."
        )
    if study._thread_local.in_optimize_loop:
        raise RuntimeError("Nested invocation of `Study.optimize` method isn't allowed.")
    if show_progress_bar and n_trials is None and timeout is not None and n_jobs != 1:
        _logger.warning("The timeout-based progress bar is not supported with n_jobs != 1.")
        show_progress_bar = False
    if n_jobs == -1:
        n_jobs = os.cpu_count() or 1

    progress_bar = _ProgressBar(show_progress_bar, n_trials, timeout)
    study._stop_flag = False
    budget = _RunBudget(study, n_trials, timeout)
    # Attach the health reporter and the autopilot before the first trial
    # records anything, so their delta baselines exclude whatever an earlier
    # run left in the process-wide registry (no-ops while off).
    health.attach(study)
    autopilot.attach(study)

    try:
        if n_jobs == 1:
            _worker(
                study, func, budget, catch, callbacks, gc_after_trial, progress_bar,
                reseed=False,
            )
        else:
            # Every worker reseeds: thread-parallel trials would otherwise
            # draw identical streams from a shared per-seed RNG.
            try:
                with ThreadPoolExecutor(max_workers=n_jobs) as pool:
                    handles = [
                        pool.submit(
                            _worker,
                            study, func, budget, catch, callbacks, gc_after_trial,
                            progress_bar, True,
                        )
                        for _ in range(n_jobs)
                    ]
                    for handle in handles:
                        handle.result()  # propagate worker exceptions
            finally:
                # A main-thread escape (e.g. KeyboardInterrupt inside
                # result()) must stop the claim stream, or the executor's
                # __exit__ join would wait for workers to drain an unbounded
                # quota.
                budget.halt()
    finally:
        study._thread_local.in_optimize_loop = False
        progress_bar.close()
        # The final health snapshot lands even when the run ends mid-interval.
        health.flush(study)
