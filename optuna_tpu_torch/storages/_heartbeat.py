"""Heartbeat subsystem: worker-death detection and stale-trial failover
(port of ``optuna_tpu/storages/_heartbeat.py``).

Parity target: ``optuna/storages/_heartbeat.py`` (``BaseHeartbeat:18``,
``HeartbeatThread:117``, ``fail_stale_trials:156``). A daemon thread records
liveness for each RUNNING trial; any worker observing a trial whose heartbeat
has expired marks it FAIL and fires the failed-trial callback (typically a
retry callback that re-enqueues a WAITING clone).
"""

from __future__ import annotations

import abc
import copy
import threading
from contextlib import contextmanager
from types import TracebackType
from typing import TYPE_CHECKING, Callable, Iterator, Sequence

from optuna_tpu_torch import logging as logging_module, telemetry
from optuna_tpu_torch.exceptions import UpdateFinishedTrialError
from optuna_tpu_torch.storages._base import BaseStorage
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = logging_module.get_logger(__name__)


class BaseHeartbeat(abc.ABC):
    """Mixin interface for storages supporting heartbeats."""

    @abc.abstractmethod
    def record_heartbeat(self, trial_id: int) -> None:
        """Persist a liveness timestamp for the trial."""
        raise NotImplementedError

    @abc.abstractmethod
    def _get_stale_trial_ids(self, study_id: int) -> list[int]:
        """RUNNING trials whose heartbeat is older than the grace period."""
        raise NotImplementedError

    @abc.abstractmethod
    def get_heartbeat_interval(self) -> int | None:
        raise NotImplementedError

    @abc.abstractmethod
    def get_failed_trial_callback(self) -> Callable[["Study", FrozenTrial], None] | None:
        raise NotImplementedError


class HeartbeatThread:
    """Daemon thread beating every ``heartbeat_interval`` seconds while the
    objective runs (reference ``_heartbeat.py:117-144``).

    Accepts either one trial id (the reference's per-trial shape) or a whole
    batch of ids: the vectorized executor advances B trials per device
    dispatch, and spawning B beat threads per batch would turn liveness into
    a thundering herd — one thread beats every trial of the batch, so a
    SIGKILL'd worker's *entire* batch goes stale together and is reaped as a
    unit by ``fail_stale_trials``.
    """

    def __init__(self, trial_id: int | Sequence[int], heartbeat: BaseHeartbeat) -> None:
        self._trial_ids = [trial_id] if isinstance(trial_id, int) else list(trial_id)
        self._heartbeat = heartbeat
        self._thread: threading.Thread | None = None
        self._stop_event: threading.Event | None = None
        self._first_beat_done = False

    def __enter__(self) -> None:
        # First beat is synchronous, *before* the thread spawns: staleness
        # queries join on recorded heartbeats, so a worker killed in the
        # window before the daemon thread's first OS-scheduled beat would
        # otherwise strand its trials RUNNING with zero heartbeat rows —
        # invisible to fail_stale_trials, permanently unreapable. Best-effort
        # only: a transient storage blip here must not abort the optimize
        # loop that is about to run the objective (the serial path has no
        # containment sweep around this context manager) — the daemon thread
        # retries immediately below, and the worst case is the pre-sync-beat
        # race window, strictly no worse than losing the trial outright.
        self._first_beat_done = False
        try:
            for trial_id in self._trial_ids:
                self._heartbeat.record_heartbeat(trial_id)
            self._first_beat_done = True
        except Exception as err:  # best-effort liveness write: a storage blip on the first beat must not kill the trial it exists to protect; the daemon thread retries immediately
            _logger.warning(
                f"synchronous first heartbeat failed ({err!r}); the beat "
                "thread will retry immediately."
            )
        self._stop_event = threading.Event()
        self._thread = threading.Thread(target=self._record_periodically, daemon=True)
        self._thread.start()

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc_value: BaseException | None,
        traceback: TracebackType | None,
    ) -> None:
        assert self._stop_event is not None and self._thread is not None
        self._stop_event.set()
        self._thread.join()

    def _beat_all(self) -> None:
        # Per-trial containment: a storage blip on one beat must not kill
        # this (sole) beat thread — an unhandled raise here would silence
        # liveness for the whole batch permanently while the worker is
        # alive, inviting a survivor to reap live trials. Log and retry at
        # the next interval instead.
        error: Exception | None = None
        for trial_id in self._trial_ids:
            try:
                self._heartbeat.record_heartbeat(trial_id)
            except Exception as err:  # liveness is best-effort by design: the beat retries next interval, and the worker's real failure modes are covered by the reaper, not by crashing the beat thread
                error = err
        if error is not None:
            _logger.warning(
                f"recording heartbeats raised {error!r}; retrying at the "
                "next interval."
            )

    def _record_periodically(self) -> None:
        # The first beat normally happened synchronously in __enter__, so the
        # loop waits first and only records the periodic refreshes; if that
        # beat hit a storage blip, retry it immediately rather than leaving
        # the trials beat-less for a whole interval.
        assert self._stop_event is not None
        interval = self._heartbeat.get_heartbeat_interval()
        assert interval is not None
        if not self._first_beat_done:
            self._beat_all()
        while not self._stop_event.wait(timeout=interval):
            self._beat_all()


def get_heartbeat_thread(trial_id: int, storage: BaseStorage):
    """Per-trial shape of :func:`get_batch_heartbeat_thread` (the reference's
    signature, used by the serial optimize loop)."""
    return get_batch_heartbeat_thread([trial_id], storage)


@contextmanager
def get_batch_heartbeat_thread(
    trial_ids: Sequence[int], storage: BaseStorage
) -> Iterator[None]:
    """One shared beat thread covering a whole dispatch batch (no-op when the
    storage has no heartbeat). Used by the vectorized executor so a preempted
    worker strands its batch *visibly*: every trial's heartbeat stops at
    once and survivors reap the batch at their next boundary."""
    if is_heartbeat_enabled(storage) and trial_ids:
        assert isinstance(storage, BaseHeartbeat)
        heartbeat_thread = HeartbeatThread(trial_ids, storage)
        with heartbeat_thread:
            yield
    else:
        yield


def is_heartbeat_enabled(storage: BaseStorage) -> bool:
    return isinstance(storage, BaseHeartbeat) and storage.get_heartbeat_interval() is not None


# Registered (not subclassed) so BaseHeartbeat's abstract methods don't block
# instantiating a wrapper around a heartbeat-less backend, while
# `isinstance(wrapper, BaseHeartbeat)` — the check `is_heartbeat_enabled` and
# `fail_stale_trials` rely on — still passes. The wrapper degrades the four
# methods to "heartbeat disabled" when its backend lacks them.
from optuna_tpu_torch.storages._base import _ForwardingStorage  # noqa: E402

BaseHeartbeat.register(_ForwardingStorage)


def fail_and_notify_trials(
    study: "Study",
    trial_ids: Sequence[int],
    *,
    reason: str | None = None,
    best_effort: bool = False,
) -> list[int]:
    """The shared copy of the *storage-callback* fail-and-re-enqueue
    sequence: CAS each trial to FAIL (optionally recording ``fail_reason``
    first), then fire the storage's failed-trial callback for every trial
    this call actually failed — so a retry callback re-enqueues its WAITING
    clone. Both storage-side reap paths go through here:
    ``fail_stale_trials`` (a survivor reaping a dead peer's batch) and
    ``Study.ask_batch``'s init-error cleanup (a worker failing its own
    half-created batch while unwinding). The vectorized executor's
    ``_fail_trials`` is the tell-path sibling — same reason-then-CAS
    ordering and ``UpdateFinishedTrialError`` race contract, but it notifies
    through ``study.tell`` + the run's own callbacks; a change to that
    contract must land in both.

    The CAS may lose to the (still-alive) owner finishing concurrently —
    losing is fine, the owner's terminal state stands and no callback fires
    here. With ``best_effort`` (the unwinding-cleanup shape) per-trial
    storage errors are swallowed so every trial is still visited.

    ``reason`` is written *before* the CAS out of necessity: storages reject
    every mutation of a finished trial, so it could never be attached after
    the FAIL commits. The consequence is a narrow benign race — an owner
    completing between the two writes leaves a stray ``fail_reason`` on a
    COMPLETE trial — which is why ``fail_reason`` is only meaningful on
    FAIL trials (retry callbacks already strip it when cloning).
    """
    storage = study._storage
    get_callback = getattr(storage, "get_failed_trial_callback", None)
    try:
        failed_trial_callback = get_callback() if get_callback is not None else None
    except Exception as err:  # best-effort cleanup: a storage that cannot even report its callback still gets the FAIL writes below
        if not best_effort:
            raise
        failed_trial_callback = None
        _logger.warning(
            f"get_failed_trial_callback raised {err!r}; failing the batch "
            "without re-enqueue callbacks."
        )
    failed_trial_ids: list[int] = []
    first_error: Exception | None = None
    for trial_id in trial_ids:
        try:
            if reason is not None:
                try:
                    storage.set_trial_system_attr(trial_id, "fail_reason", reason)
                except UpdateFinishedTrialError:
                    raise  # race lost: handled by the outer except
                except Exception as err:  # the reason attr is diagnostics; a blip on it must not skip the FAIL write below ("losing a clone is recoverable, losing the FAIL is not")
                    _logger.warning(
                        f"writing fail_reason for trial_id {trial_id} raised "
                        f"{err!r}; failing the trial without it."
                    )
            if storage.set_trial_state_values(trial_id, state=TrialState.FAIL):
                failed_trial_ids.append(trial_id)
        except UpdateFinishedTrialError:
            # A concurrent reaper (or the trial's still-alive owner) finished
            # it between our read and this write — storages surface that as
            # an error, not a False CAS. Losing the race is fine: the
            # winner's terminal state stands and it notified for it.
            continue
        except Exception as err:  # containment must visit every trial: one FAIL write hitting a storage fault must not abort the loop and leave the rest RUNNING; the first error re-raises below unless the caller is itself unwinding (best_effort)
            if first_error is None:
                first_error = err
            _logger.warning(
                f"failing trial_id {trial_id} raised {err!r}; continuing so "
                "the remaining trials are still visited."
            )
            continue
    # Callbacks fire only after *every* trial holds a terminal state (same
    # deferral as the executor's _fail_trials): a retry callback hitting a
    # storage blip mid-loop must not leave the remaining stale trials
    # un-failed — losing a clone is recoverable, losing the FAIL is not.
    if failed_trial_callback is not None:
        for trial_id in failed_trial_ids:
            try:
                failed_trial_callback(study, copy.deepcopy(storage.get_trial(trial_id)))
            except Exception as err:  # best-effort cleanup while unwinding: the caller's original error matters more than one clone's re-enqueue; logged so the lost lineage is diagnosable
                if not best_effort:
                    raise
                _logger.warning(
                    f"failed-trial callback for trial_id {trial_id} raised "
                    f"{err!r}; its retry clone may not have been enqueued."
                )
    if first_error is not None and not best_effort:
        raise first_error
    return failed_trial_ids


def fail_stale_trials(study: "Study") -> None:
    """Mark dead workers' RUNNING trials FAIL, then fire the retry callback
    (reference ``_heartbeat.py:156-203``). Called at each ``_run_trial`` start."""
    storage = study._storage
    if not isinstance(storage, BaseHeartbeat):
        return
    if not is_heartbeat_enabled(storage):
        return
    reaped = fail_and_notify_trials(study, storage._get_stale_trial_ids(study._study_id))
    if reaped:
        # Counted here (not in fail_and_notify_trials): only this path is a
        # dead-worker *reap* — ask_batch's unwinding cleanup shares the
        # helper but is its own failure story.
        telemetry.count("heartbeat.reap", len(reaped))
