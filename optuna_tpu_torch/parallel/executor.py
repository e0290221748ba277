"""Resilient batched trial execution: the batch as the unit of failure (port
of ``optuna_tpu/parallel/executor.py``).

``optimize_vectorized`` advances B trials a device dispatch, but a batch
that can only succeed whole turns one poison trial into B lost trials.
This module owns the containment layers that make a partial failure of a
batch survivable:

1. **Non-finite quarantine**: the guarded wrapper returns a finite mask
   beside the values, computed on the device (``torch.isfinite``, reduced
   over the objective axis), so NaN/Inf trials are told FAIL under a
   ``non_finite=`` policy (:data:`NON_FINITE_POLICIES`) while the rest of
   the batch completes, and the sampler's fits never see NaN.
2. **Crash containment and bisection**: a dispatch that raises marks its
   trials FAIL instead of leaving them RUNNING; with
   ``bisect_on_error=True`` the batch is first split recursively (at most
   2·log₂B re-dispatches), so a poison trial fails alone and the other
   B - 1 are salvaged. An out-of-memory error instead halves the running
   batch size, paced by the :class:`RetryPolicy` backoff, until the
   dispatch fits, and two clean batches at the clamped width earn one
   doubling back toward the requested size.
3. **Preemption failover**: the batch shares one heartbeat thread, and
   ``fail_stale_trials`` runs at every batch boundary, so a killed
   worker's batch is reaped by survivors and enqueued again by
   ``RetryFailedTrialCallback`` (``ask_batch`` claims WAITING clones
   first).
4. **Dispatch deadline**: a watchdog on an injectable clock bounds a hung
   dispatch and turns it into the same FAIL path.

Worker death (``BaseException``: ``SystemExit``, Ctrl-C, the fault kit's
``SimulatedWorkerDeath``) goes through every layer: a dead worker never
tells, and layer 3 reaps what it leaves.

Where the card changes things:

* **One host read a dispatch.** A torch call returns before the card has
  finished, as a jit call does. ``_read_to_host`` stacks the values and
  the finite mask into one tensor and reads it with one ``.cpu()``, the
  dispatch's only synchronizing call; the deadline watchdog runs the call
  and that read, so it bounds the card's work and not only the launch.
* **Out of memory** on the card is ``torch.OutOfMemoryError``
  (``torch.cuda.OutOfMemoryError``, "CUDA out of memory"). It is classified
  by type as well as by the reference's text rule (``RESOURCE_EXHAUSTED``
  or "out of memory"), which the fault kit's ``FakeResourceExhaustedError``
  relies on. Before the halves are dispatched, the failed dispatch's frames
  are cleared, so the tensors it allocated are freed and not held by the
  traceback.
* **Device faults are not contained.** A CUDA error other than OOM (an
  illegal address, a launch failure) poisons the context: every later
  dispatch fails with it, and so does a ``KernelBuildError``. Bisecting it
  would fail the study trial by trial and hide the fault. So a dispatch
  error that ``samplers._resilience.is_device_fault`` classifies FAILs the
  batch's trials (the split halves not yet dispatched included) and is
  re-raised at once, with no bisection; a sampler's device fault during the
  ask is re-raised too, not degraded to independent sampling. This is the
  one difference from the reference, and it is the one that
  ``GuardedSampler`` makes.
* **A mesh is ranks, not devices.** With a ``mesh`` the batch is padded to
  a multiple of the ``trials`` shards (the last row repeated), OOM halving
  floors at one row a shard, and ``batch_size`` defaults to the shard
  count, as in the reference. On several ranks each dispatch is one
  :class:`~optuna_tpu_torch.parallel._mesh.MeshDispatch`: every rank
  uploads, evaluates and reads back its rows and the ranks gather them
  with a status each, so a failed upload, a poison row, an OOM or a
  timed-out evaluation on one rank becomes the same error on every rank,
  and every rank takes the same containment branch.
  ``dispatch_deadline_s`` then bounds each rank's evaluation of its rows,
  inside the gather, so no rank abandons a collective. Rank 0 broadcasts
  each batch's packed columns first. Outside the lockstep pod, rank 0 alone
  runs this loop and every other rank runs :meth:`_follow`, which
  evaluates what rank 0 dispatches until rank 0's run ends; a follower
  passes over only the agreed errors, and raises any other.
* **An abandoned dispatch keeps running.** When the deadline trips, the
  watchdog thread is abandoned (a daemon) and may keep launching kernels on
  the card while the loop goes on, as the reference's keeps dispatching to
  the TPU; its result is discarded. The contention it causes is not
  measured. :func:`run_with_deadline` is also ``GuardedSampler``'s fit
  deadline.

**Observability and control.** Each phase is one ``telemetry.span``: one
interval, read on one clock, feeds the phase histogram, the SLO sink and
the flight ring, and holds the phase's ``torch.profiler`` range while a
profiler runs. A batch's ask is two blocks (the batch's creation, then its
suggestions inside the heartbeat), stitched into one ``ask`` observation;
inside them ``ask.fit`` and ``ask.propose`` (the sampler's batch ask),
``ask.create`` and ``ask.suggest``; ``dispatch`` holds ``dispatch.wait``,
the host blocked in the one read; then ``tell``. Every span of a batch
carries its tag (``<run token>/<batch number>``) in the flight ring, and
each trial's ask and tell are flight events; the quarantine count is a
``device_stats`` tap; a terminal batch failure flushes a flight
postmortem. At every batch boundary the card's memory gauges are sampled,
the health reporter publishes and the autopilot steps with this executor
as the target of its two actuators: ``autopilot_pin_batch_width``
(``executor.pin_shapes``) and ``autopilot_tighten_regrowth``
(``executor.tighten_regrowth``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import traceback
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np
import torch

from optuna_tpu_torch import _tracing, autopilot, device_stats, flight, health, telemetry
from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.exceptions import OptunaTPUError, UpdateFinishedTrialError
from optuna_tpu_torch.logging import get_logger, warn_once
from optuna_tpu_torch.samplers._resilience import (
    FALLBACK_POLICIES,
    SAMPLER_FALLBACK_ATTR_PREFIX,
    is_device_fault,
    non_finite_param_names,
)
from optuna_tpu_torch.storages._callbacks import EXECUTOR_ATTR_PREFIX
from optuna_tpu_torch.storages._heartbeat import (
    fail_stale_trials,
    get_batch_heartbeat_thread,
    is_heartbeat_enabled,
)
from optuna_tpu_torch.storages._retry import RetryPolicy
from optuna_tpu_torch.trial._state import TrialState
from optuna_tpu_torch.trial._trial import Trial

if TYPE_CHECKING:
    from optuna_tpu_torch.autopilot import AutopilotPolicy
    from optuna_tpu_torch.parallel.vectorized import VectorizedObjective
    from optuna_tpu_torch.study.study import Study
    from optuna_tpu_torch.trial._frozen import FrozenTrial

_logger = get_logger(__name__)

#: Monotonic per-executor run tokens (see ``_run_token``).
_executor_seq = itertools.count()

#: The accepted ``non_finite=`` policy literals and what each does to a
#: quarantined (NaN/±Inf) trial.
NON_FINITE_POLICIES: dict[str, str] = {
    "fail": "quarantine: non-finite trials are told FAIL; the rest of the batch completes",
    "raise": "strict: quarantine as FAIL first, then raise NonFiniteObjectiveError",
    "clip": "degrade: values pass through torch.nan_to_num on the device; every trial completes",
}


class DispatchTimeoutError(OptunaTPUError, TimeoutError):
    """A device dispatch overran ``dispatch_deadline_s`` and was abandoned."""


def run_with_deadline(
    fn: Callable[[], "object"],
    deadline_s: float,
    clock: Callable[[], float] = time.monotonic,
    *,
    describe: str = "device dispatch",
    thread_name: str = "optuna-tpu-dispatch",
) -> "object":
    """Run ``fn`` on a watchdog thread; raise :class:`DispatchTimeoutError`
    when it overruns ``deadline_s`` (measured on the injectable ``clock``).

    The hung thread is abandoned (daemon) and its eventual result, if any,
    discarded — the caller takes its failure path. The batch executor's
    dispatch watchdog and the sampler resilience layer's fit watchdog
    (:mod:`optuna_tpu_torch.samplers._resilience`) use it so that a hang
    becomes a contained failure, not a stuck study.
    """
    box: list = []
    failure: list[BaseException] = []

    def _target() -> None:
        try:
            box.append(fn())
        except BaseException as err:  # graphlint: ignore[PY001] -- thread trampoline: the error is re-raised verbatim on the dispatching thread below, nothing is swallowed
            failure.append(err)

    worker = threading.Thread(target=_target, name=thread_name, daemon=True)
    start = clock()
    worker.start()
    while worker.is_alive():
        remaining = deadline_s - (clock() - start)
        if remaining <= 0:
            break
        worker.join(timeout=min(0.05, remaining))
    if worker.is_alive():
        raise DispatchTimeoutError(
            f"{describe} exceeded the {deadline_s}s deadline"
        )
    if failure:
        raise failure[0]
    return box[0]


class NonFiniteObjectiveError(OptunaTPUError, ValueError):
    """Raised under ``non_finite='raise'`` *after* the poisoned trials were
    quarantined as FAIL — the study is left containment-clean either way."""


def build_non_finite_guard(fn: Callable, *, clip: bool) -> Callable:
    """Wrap a batched objective so the dispatch returns ``(values, finite)``.

    ``finite`` is a per-trial bool tensor computed on the device
    (``torch.isfinite``, reduced over the objective axis for several
    objectives), so the quarantine decision comes back with the values in
    the dispatch's one read. With ``clip`` the values also pass through
    ``torch.nan_to_num`` on the device (NaN -> 0, ±Inf -> the dtype's
    extremes) while ``finite`` still reports the raw mask.
    """

    def _guard(params, *extra):
        values = fn(params, *extra)
        finite = torch.isfinite(values)
        if finite.ndim > 1:
            finite = finite.all(dim=-1)
        if clip:
            values = torch.nan_to_num(values)
        return values, finite

    return _guard


def _read_to_host(values: torch.Tensor, finite: torch.Tensor | None = None) -> tuple[np.ndarray, np.ndarray | None]:
    """A dispatch's one host read: the values (and the finite mask) stacked
    into one tensor and read with one ``.cpu()``, the dispatch's only
    synchronizing call and its ``dispatch.wait`` phase. Returns ``(values,
    finite)`` as host arrays, the values in their shape and ``finite`` a
    bool vector (``None`` without a mask)."""
    b = values.shape[0]
    dtype = values.dtype if values.is_floating_point() else torch.float32
    cols = [values.reshape(b, -1).to(dtype)]
    if finite is not None:
        cols.append(finite.reshape(b, 1).to(dtype))
    stacked = torch.cat(cols, dim=1).detach()
    with telemetry.span("dispatch.wait"):
        host = stacked.cpu().numpy()
    if finite is None:
        return host.reshape(tuple(values.shape)), None
    return host[:, :-1].reshape(tuple(values.shape)), host[:, -1] != 0


def _is_oom_error(err: BaseException) -> bool:
    """The card's allocation failure by type (``torch.OutOfMemoryError``),
    or any error by the reference's text rule (``RESOURCE_EXHAUSTED``, or
    "out of memory" in any case)."""
    oom_type = getattr(torch, "OutOfMemoryError", None) or getattr(torch.cuda, "OutOfMemoryError", None)
    if oom_type is not None and isinstance(err, oom_type):
        return True
    text = f"{type(err).__name__}: {err}"
    return "RESOURCE_EXHAUSTED" in text or "out of memory" in text.lower()


def _is_uncontained_device_fault(err: BaseException) -> bool:
    from optuna_tpu_torch.parallel._mesh import ShardDeviceFault

    return isinstance(err, ShardDeviceFault) or (is_device_fault(err) and not _is_oom_error(err))


class ResilientBatchExecutor:
    """Fault-tolerant engine behind :func:`optimize_vectorized`.

    One instance = one ``run`` loop over a study; the guarded objective
    wrapper is memoized on the objective itself, so executors are cheap to
    construct per call. ``device`` (None: the card, or the mesh's device) is
    where the packed parameters go. On a follower rank of a multi-rank
    ``mesh`` (see the module docstring) ``study`` is not read and may be
    None.
    """

    def __init__(
        self,
        study: "Study",
        objective: "VectorizedObjective",
        *,
        batch_size: int | None = None,
        mesh: object = None,
        batch_axis: str = "trials",
        callbacks: Sequence[Callable] | None = None,
        non_finite: str = "fail",
        fallback: str | None = None,
        bisect_on_error: bool = True,
        retry_policy: RetryPolicy | None = None,
        dispatch_deadline_s: float | None = None,
        autopilot: "str | AutopilotPolicy | None" = None,
        clock: Callable[[], float] = time.monotonic,
        device: "str | torch.device | None" = None,
    ) -> None:
        from optuna_tpu_torch.parallel import _mesh

        if non_finite not in NON_FINITE_POLICIES:
            raise ValueError(
                f"non_finite must be one of {sorted(NON_FINITE_POLICIES)}; "
                f"got {non_finite!r}."
            )
        if fallback is None:
            # Inherit the study's declared policy: a study built with
            # sampler_fallback='raise' asked for loud sampler failures.
            # Unguarded studies default to 'independent'.
            fallback = getattr(getattr(study, "sampler", None), "fallback", None)
            if fallback not in FALLBACK_POLICIES:
                fallback = "independent"
        if fallback not in FALLBACK_POLICIES:
            raise ValueError(
                f"fallback must be one of {sorted(FALLBACK_POLICIES)}; "
                f"got {fallback!r}."
            )
        if batch_size is not None and batch_size < 1:
            # ask_batch(0) returns [] and run() would never advance.
            raise ValueError(f"batch_size must be >= 1; got {batch_size}.")
        self._study = study
        self._objective = objective
        self._mesh = mesh
        # The batch is sharded over the batch axis only: one row a shard is
        # the narrowest dispatch every rank has rows of.
        self._n_dev = _mesh.n_batch_shards(mesh, batch_axis) if mesh is not None else 1
        self._role = _mesh.role(mesh, pod=False)
        self._device = resolve_device(device) if device is not None or mesh is None else _mesh.mesh_device(mesh)
        self._callbacks = list(callbacks or ())
        self._non_finite = non_finite
        self._fallback = fallback
        self._batch_fallback_reason: str | None = None
        self._bisect = bisect_on_error
        self._policy = retry_policy if retry_policy is not None else RetryPolicy()
        # Leaf and timeout strikes share the retry policy's attempt count
        # with a floor of 2: max_attempts paces OOM halving, and a user
        # lowering it to 1 must not set the poison-trial tolerance to zero
        # (the first bisection leaf would re-raise before any salvage).
        self._strike_budget = max(2, self._policy.max_attempts)
        self._deadline_s = dispatch_deadline_s
        self._clock = clock
        self._batch_size = (self._n_dev if mesh is not None else 8) if batch_size is None else batch_size
        self._requested_batch_size = self._batch_size
        self._grow_streak = 0
        # Clean full-width batches needed for one doubling back toward the
        # requested size after an OOM clamp; the autopilot's
        # tighten_regrowth action stretches it under a quarantine storm.
        self._grow_streak_required = 2
        self._autopilot_request = autopilot
        self._oom_seen = False
        self._oom_attempts = 0
        self._timeout_strikes = 0
        self._timeout_width = 0
        self._leaf_strikes = 0
        self._batch_seq = 0
        self._batch_tag: str | None = None
        self._guarded = objective.guarded(mesh, batch_axis, non_finite)
        # Tells this executor's dispatch bookkeeping from another worker's in
        # a shared storage, and keys warn_once; monotonic, so a recycled
        # address never inherits a dead executor's warned state.
        self._run_token = f"{os.getpid():x}.{next(_executor_seq):x}"

    # ------------------------------------------------------------------- loop

    def run(self, n_trials: int) -> None:
        """Advance ``n_trials`` trials in batches, containing per-batch
        faults so that no survivable failure leaves a trial RUNNING. On a
        follower rank, evaluate rank 0's dispatches until its run ends."""
        if self._role == "follower":
            self._follow()
            return
        if self._role != "leader":
            self._run(n_trials)
            return
        from optuna_tpu_torch.parallel import _mesh

        # The followers wait in a broadcast: end it on a return and on an
        # error. A worker's death (BaseException) sends nothing, since the
        # followers die with it (the chaos kit kills every rank at one
        # dispatch); a rank that dies alone fails the others at the
        # process group's timeout.
        try:
            self._run(n_trials)
        except Exception as err:  # graphlint: ignore[PY001] -- stop-broadcast boundary: the followers wait on it, so any error ends their wait with its text, then re-raises unchanged
            _mesh.send_stop(f"{type(err).__name__}: {err}"[:500])
            raise
        _mesh.send_stop(None)

    def _follow(self) -> None:
        """A follower rank's loop: evaluate each batch rank 0 broadcasts,
        in step with its dispatches, until it sends the stop. A failed
        dispatch is rank 0's to contain (it raised the same agreed error
        there); what it dispatches next arrives here next."""
        from optuna_tpu_torch.parallel import _mesh

        while True:
            kind, payload = _mesh.receive()
            if kind == "stop":
                if payload is not None:
                    raise RuntimeError(f"rank 0's run ended with {payload}")
                return
            try:
                self._dispatch(payload)
            except (_mesh.ShardDispatchError, torch.OutOfMemoryError, DispatchTimeoutError):
                # Agreed errors: rank 0 raised the same one and contains it;
                # a device fault comes back as the stop's error. Anything
                # else left the ranks out of step, so it is raised.
                continue

    def _run(self, n_trials: int) -> None:
        study = self._study
        if study._thread_local.in_optimize_loop:
            # A nested run() from a callback would clobber the outer loop's
            # pending stop() through the reset below.
            raise RuntimeError(
                "Nested invocation of `optimize_vectorized` isn't allowed."
            )
        study._stop_flag = False
        study._thread_local.in_optimize_loop = True  # callbacks may stop()
        # Attach the reporter and the autopilot before the first batch
        # records anything (their delta baselines); no-ops unless opted in.
        health.attach(study)
        autopilot.attach(study, config=self._autopilot_request)
        try:
            done = 0
            with _tracing.maybe_trace_from_env():
                while done < n_trials and not study._stop_flag:
                    done += self._run_one_batch(n_trials - done)
        finally:
            study._thread_local.in_optimize_loop = False
            # The final health snapshot lands even mid-interval.
            health.flush(study)

    def _run_one_batch(self, remaining: int) -> int:
        """One ask -> heartbeat(suggest + dispatch + tell) cycle; returns the
        batch width advanced."""
        study = self._study
        # Without a heartbeat on the storage there is nothing to reap and
        # nothing to beat: the per-batch heartbeat thread is never built.
        heartbeat = is_heartbeat_enabled(study._storage)
        if heartbeat:
            # Reap a dead peer's batch first, so ask_batch claims its WAITING
            # clones.
            fail_stale_trials(study)
        b = min(self._batch_size, remaining)
        size_before = self._batch_size
        self._oom_seen = False
        self._batch_tag = f"{self._run_token}/{self._batch_seq}"
        self._batch_seq += 1
        # The ask phase spans two blocks (the batch creation here and the
        # suggestions inside the heartbeat), stitched into one observation.
        ask_t0 = self._clock()
        with telemetry.span("ask", tag=self._batch_tag, observe=False):
            trials, proposals = self._ask_batch(b)
        ask_seconds = self._clock() - ask_t0
        try:
            if heartbeat:
                # Suggestion runs inside the heartbeat, whose __enter__ beats
                # once synchronously: a worker killed mid-suggest leaves a
                # reapable batch.
                with get_batch_heartbeat_thread([t._trial_id for t in trials], study._storage):
                    self._suggest_and_run(trials, proposals, ask_seconds)
            else:
                self._suggest_and_run(trials, proposals, ask_seconds)
        except Exception as err:  # graphlint: ignore[PY001] -- last-line containment sweep: whatever escaped between ask and tell must not leave trials RUNNING; the original error re-raises below. BaseException (worker death) punches through for heartbeat failover
            # The error is about to surface: flush the flight recorder's tail
            # first (one dump a run), so the sequence that led here outlives
            # the process.
            flight.postmortem(
                f"batch aborted: {type(err).__name__}: {err}"[:500],
                key=f"executor:{self._run_token}",
            )
            # _fail_trials skips trials already terminal, so the sweep is
            # idempotent over what the inner containment committed.
            try:
                self._fail_trials(trials, f"batch aborted: {err!r}")
            except Exception as sweep_err:  # graphlint: ignore[PY001] -- the storage is down mid-sweep; the original batch error matters more than the sweep's, so log and fall through to the raise
                _logger.warning(
                    f"containment sweep after a batch error itself "
                    f"raised {sweep_err!r}; surfacing the original "
                    "error."
                )
            raise
        self._maybe_grow(len(trials), size_before)
        # Batch boundary: the card's memory high-water mark, the health
        # publish and the autopilot step (this executor is the target of the
        # batch-width actuators); module-global checks while all are off.
        flight.sample_device_gauges()
        health.maybe_report(study)
        autopilot.maybe_step(study, executor=self)
        return len(trials)

    def _suggest_and_run(self, trials: list[Trial], proposals: list | None, ask_seconds: float) -> None:
        ask_t0 = self._clock()
        with telemetry.span("ask", tag=self._batch_tag, observe=False), telemetry.span("ask.suggest"):
            self._prepare_batch(trials, proposals)
        telemetry.observe_phase("ask", ask_seconds + (self._clock() - ask_t0))
        self._run_batch(trials)

    # ----------------------------------------------------------------- phases

    def _maybe_grow(self, batch_width: int, size_before: int) -> None:
        """Probationary regrowth after an OOM clamp: two consecutive clean
        full-width batches buy one doubling back toward the requested size;
        a recurring OOM clamps again and resets the streak."""
        if self._batch_size < size_before or self._oom_seen:
            # The batch clamped, or a sub-dispatch hit an OOM contained
            # without clamping: memory pressure either way, not clean.
            self._grow_streak = 0
            return
        if (
            self._batch_size >= self._requested_batch_size
            or batch_width < self._batch_size  # tail batch: not capacity evidence
        ):
            return
        self._grow_streak += 1
        if self._grow_streak >= self._grow_streak_required:
            self._grow_streak = 0
            self._batch_size = min(self._requested_batch_size, self._batch_size * 2)
            _logger.info(
                f"{self._grow_streak_required} clean batches at the clamped "
                f"width; growing batch_size back to {self._batch_size}."
            )

    # ------------------------------------------------- autopilot actuators

    def autopilot_pin_batch_width(self) -> Callable[[], None]:
        """Freeze the dispatch width at the current batch size: regrowth
        probes stop, so every later batch dispatches at a width already
        seen — the autopilot's ``executor.pin_shapes`` remediation for
        retrace churn. OOM halving still shrinks below the pin. Returns the
        undo that restores the requested width."""
        previous = self._requested_batch_size
        self._requested_batch_size = self._batch_size
        self._grow_streak = 0

        def undo() -> None:
            self._requested_batch_size = previous

        return undo

    def autopilot_tighten_regrowth(self, streak: int = 8) -> Callable[[], None]:
        """Stretch the probationary regrowth schedule: ``streak`` clean
        full-width batches (instead of 2) buy each doubling back toward the
        requested size — the autopilot's ``executor.tighten_regrowth``
        remediation while quarantines eat the budget. Returns the undo."""
        if streak < 1:
            raise ValueError(f"streak must be >= 1; got {streak}.")
        previous = self._grow_streak_required
        self._grow_streak_required = int(streak)
        self._grow_streak = 0

        def undo() -> None:
            self._grow_streak_required = previous

        return undo

    def _ask_batch(self, b: int) -> tuple[list[Trial], list | None]:
        """Create the batch's trials (one storage batch). A sampler raising
        in ``sample_relative_batch`` does so before any trial exists; under
        ``fallback='independent'`` the batch degrades to per-trial
        independent suggestion instead of aborting the run. A device fault
        is re-raised."""
        study = self._study
        proposals = None
        self._batch_fallback_reason = None
        if hasattr(study.sampler, "sample_relative_batch"):
            try:
                proposals = study.sampler.sample_relative_batch(study, self._objective.search_space, b)
            except Exception as err:  # graphlint: ignore[PY001] -- sampler-fault containment boundary: a batch-fit crash degrades this batch to independent sampling under fallback='independent'; 'raise' and device faults re-raise
                if self._fallback == "raise" or is_device_fault(err):
                    raise
                self._batch_fallback_reason = f"{type(err).__name__}: {err}"[:500]
                _logger.warning(
                    f"sampler batch suggestion raised {err!r}; falling back "
                    "to independent sampling for this batch."
                )
            else:
                if proposals is None:
                    # A GuardedSampler returns None after containing its
                    # sampler's batch-fit crash: degrade the batch once
                    # instead of re-attempting the fit per trial.
                    self._batch_fallback_reason = getattr(study.sampler, "last_batch_fallback_reason", None)
        with telemetry.span("ask.create"):
            return study.ask_batch(b), proposals

    def _prepare_batch(self, trials: list[Trial], proposals: list | None) -> None:
        """Suggest every trial's parameters and tag the dispatch
        bookkeeping. Runs inside the batch heartbeat and under run()'s
        containment sweep."""
        study = self._study
        space = self._objective.search_space
        # Which batch and slot a trial rode matters only where failover can
        # strand a batch (heartbeat storages, which already pay per-trial
        # writes); elsewhere it would be B extra writes a batch.
        tag_dispatch = is_heartbeat_enabled(study._storage)
        for i, trial in enumerate(trials):
            if proposals is not None:
                proposal = proposals[i]
                bad = non_finite_param_names(proposal, space)
                if bad:
                    # Only the poisoned trial degrades to independent dims;
                    # its batch-mates keep their joint proposals.
                    reason = f"non-finite proposal for {bad}: { {k: proposal[k] for k in bad} }"
                    if self._fallback == "raise":
                        raise ValueError(reason)
                    self._note_sampler_fallback(trial, "relative_batch", reason)
                    proposal = {k: v for k, v in proposal.items() if k not in bad}
                trial.relative_search_space = space
                trial.relative_params = proposal
            elif self._batch_fallback_reason is not None:
                # The batch fit raised before the trials existed: an empty
                # relative proposal sends every dim through the independent
                # path, and each trial records why.
                trial.relative_search_space = space
                trial.relative_params = {}
                self._note_sampler_fallback(trial, "relative_batch", self._batch_fallback_reason)
            elif self._needs_relative(trial):
                # Per-trial relative sampling (no batch hook, or the sampler
                # declined), forced now under containment: a sampler crash
                # degrades this trial alone. Trials that would never sample
                # relatively (retry clones with every param fixed) are not
                # forced through a fit, so the sampler's RNG stream matches
                # the lazy path's.
                try:
                    relative = trial._ensure_relative_params()
                except Exception as err:  # graphlint: ignore[PY001] -- sampler-fault containment boundary: a per-trial fit crash degrades this trial to independent sampling under fallback='independent'; 'raise' and device faults re-raise
                    if self._fallback == "raise" or is_device_fault(err):
                        raise
                    self._note_sampler_fallback(trial, "relative", f"{type(err).__name__}: {err}"[:500])
                    trial.relative_params = {}
                else:
                    bad = non_finite_param_names(relative, trial.relative_search_space)
                    if bad:
                        reason = f"non-finite proposal for {bad}: { {k: relative[k] for k in bad} }"
                        if self._fallback == "raise":
                            raise ValueError(reason)
                        self._note_sampler_fallback(trial, "relative", reason)
                        trial.relative_params = {k: v for k, v in relative.items() if k not in bad}
            for name, dist in space.items():
                # Claimed retry clones carry fixed_params, which _suggest
                # honours before any sampler proposal.
                trial._suggest(name, dist)
            if tag_dispatch:
                study._storage.set_trial_system_attr(
                    trial._trial_id,
                    EXECUTOR_ATTR_PREFIX + "dispatch",
                    {"batch": self._batch_tag, "slot": i},
                )
            flight.trial_event("ask", trial.number)

    def _needs_relative(self, trial: Trial) -> bool:
        """Would the lazy suggest path call ``sample_relative`` for this
        trial? True iff some objective-space param is in the trial's relative
        search space and not pinned by ``fixed_params``."""
        fixed = trial._cached_frozen_trial.system_attrs.get("fixed_params") or {}
        return any(
            name in trial.relative_search_space and name not in fixed
            for name in self._objective.search_space
        )

    def _note_sampler_fallback(self, trial: Trial, phase: str, reason: str) -> None:
        """Record why a trial's suggestion degraded, in ``GuardedSampler``'s
        attr namespace (not ``batch_exec:``: the lineage describes the
        logical trial and survives retry-clone attr stripping). Every
        occurrence is counted and attributed; the log warns once per run and
        condition."""
        family = phase.split(":", 1)[0]
        telemetry.count("sampler.fallback." + family)
        try:
            self._study._storage.set_trial_system_attr(
                trial._trial_id, SAMPLER_FALLBACK_ATTR_PREFIX + phase, reason[:500]
            )
        except Exception as err:  # graphlint: ignore[PY001] -- the attr is diagnostics; a storage blip on it must not turn a contained sampler fault into a batch abort
            _logger.warning(
                f"recording sampler fallback for trial {trial.number} raised "
                f"{err!r}; continuing with the fallback anyway."
            )
        warn_once(
            _logger,
            f"executor_fallback:{self._run_token}:{family}",
            f"trial {trial.number}: sampler suggestion degraded to the "
            f"independent path during {phase}: {reason}. Further {phase} "
            "fallbacks in this run are recorded in "
            f"'{SAMPLER_FALLBACK_ATTR_PREFIX}*' trial attrs (and the "
            "sampler.fallback telemetry counter) without a log line.",
        )

    def _run_batch(self, trials: list[Trial]) -> None:
        """Evaluate and tell one (sub-)batch with full containment."""
        try:
            values, finite = self._eval(trials)
        except Exception as err:  # graphlint: ignore[PY001] -- containment boundary: every dispatch error becomes FAIL tells (plus bisection/halving); BaseException (worker death, Ctrl-C) punches through for heartbeat failover
            self._contain(trials, err)
            return
        with telemetry.span("tell", tag=self._batch_tag):
            self._tell_batch(trials, values, finite)

    def _eval(self, trials: list[Trial]) -> tuple[np.ndarray, np.ndarray]:
        from optuna_tpu_torch.parallel import _mesh
        from optuna_tpu_torch.parallel.vectorized import _pack_params

        b = len(trials)
        packed = _pack_params(trials, self._objective.search_space)
        if self._mesh is not None:
            # The narrowest padding every shard has rows of: the last row
            # repeated up to a multiple of the shard count.
            b_eval = -(-b // self._n_dev) * self._n_dev
            if b_eval > b:
                packed = {k: np.concatenate([v, np.repeat(v[-1:], b_eval - b, axis=0)]) for k, v in packed.items()}
            packed = _mesh.share_batch(packed)
        values, finite = self._dispatch(packed)
        values, finite = values[:b], finite[:b]
        # Device-stat tap: the quarantine count from the finite mask the
        # dispatch already read. Taken per completed dispatch, so bisection
        # and halving sum to one count per quarantined trial; 0 under
        # 'clip', where nothing is quarantined.
        if telemetry.enabled() and self._non_finite != "clip":
            device_stats.harvest({"executor.quarantined": int(b - np.count_nonzero(finite))})
        # A dispatch completed: the device is alive and the width fits.
        self._oom_attempts = 0
        self._leaf_strikes = 0
        if b >= self._timeout_width:
            # Hang evidence clears only at (or above) the width that hung: a
            # width-dependent hang whose halves always complete must still
            # exhaust the strike budget.
            self._timeout_strikes = 0
            self._timeout_width = 0
        return values, finite

    def _upload(self, args: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Host columns on the device. To the card each goes through pinned
        host memory with a non-blocking copy, so the upload makes no
        synchronizing call and the host read stays the dispatch's only
        one."""
        if self._device.type != "cuda":
            return {k: v.to(self._device) for k, v in args.items()}
        return {k: v.pin_memory().to(self._device, non_blocking=True) for k, v in args.items()}

    def _realize(self, packed: dict[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        """Upload the packed columns, call the guarded objective and read
        its values and finite mask with :func:`_read_to_host`. The call
        returns before the card has finished; the read waits for it, so the
        deadline (around this whole method) bounds the device work. Over a
        mesh the upload and the read run inside the
        :class:`~optuna_tpu_torch.parallel._mesh.MeshDispatch`'s status
        boundary, on this rank's rows."""
        host = {k: torch.from_numpy(v) for k, v in packed.items()}
        if self._mesh is not None:
            return self._guarded(host, upload=self._upload)
        return _read_to_host(*self._guarded(self._upload(host)))

    def _dispatch(self, packed: dict[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        from optuna_tpu_torch.parallel import _mesh

        with telemetry.span("dispatch", tag=self._batch_tag):
            if self._deadline_s is None:
                return self._realize(packed)
            if self._mesh is not None and _mesh.world_size() > 1:
                # Each rank's rows are bounded inside the gather; the
                # collectives themselves are never abandoned.
                with _mesh.deadline_scope(self._deadline_s, self._clock):
                    return self._realize(packed)
            return run_with_deadline(lambda: self._realize(packed), self._deadline_s, self._clock)

    def _contain(self, trials: list[Trial], err: Exception) -> None:
        """A dispatch over ``trials`` raised ``err``: salvage what we can,
        FAIL the rest, never leave anything RUNNING."""
        b = len(trials)
        if _is_uncontained_device_fault(err):
            self._fail_trials(trials, f"device fault in the dispatch: {err!r}")
            raise err
        if _is_oom_error(err) and b > self._n_dev:
            # Halving is bounded by log2(b) re-dispatches by construction;
            # the attempt counter (reset by every completed dispatch) only
            # paces the backoff.
            self._oom_attempts += 1
            self._oom_seen = True
            telemetry.count("executor.oom_halving")
            # Free what the failed dispatch allocated before the halves run:
            # the traceback's frames hold its tensors.
            traceback.clear_frames(err.__traceback__)
            if b >= self._batch_size:
                # Only a full-width dispatch is capacity evidence: an OOM in
                # a bisection sub-dispatch must not clamp the study's batch
                # size below a width the device just ran. Rounded down to a
                # multiple of the shard count, which padding would restore.
                self._batch_size = max(self._n_dev, (b // 2) // self._n_dev * self._n_dev)
                self._grow_streak = 0
            self._policy.backoff(
                self._oom_attempts,
                announce=lambda delay: _logger.warning(
                    f"dispatch of {b} trials hit {type(err).__name__} "
                    f"(out of memory); halving to {(b + 1) // 2} "
                    f"and retrying after {delay:.3f}s backoff."
                ),
            )
            self._run_splits([trials[: (b + 1) // 2], trials[(b + 1) // 2 :]])
            return
        # An OOM-shaped error at one row a shard falls through to the generic
        # containment: the text rule can misfire on a poison trial whose
        # error merely looks OOM-shaped, and leaf containment keeps the
        # healthy trials' salvage either way.
        if isinstance(err, DispatchTimeoutError):
            # Each timed-out dispatch abandons a thread; consecutive timeouts
            # share a bounded budget, cleared only by a completed dispatch at
            # (or above) the hung width.
            self._timeout_strikes += 1
            self._timeout_width = max(self._timeout_width, b)
            telemetry.count("executor.dispatch_timeout")
            if self._timeout_strikes >= self._strike_budget:
                self._fail_trials(trials, f"batch dispatch raised: {err!r}")
                raise err
        if self._bisect and b > 1:
            telemetry.count("executor.bisection")
            _logger.warning(
                f"dispatch of {b} trials raised {err!r}; bisecting to isolate "
                "the poison trial(s)."
            )
            self._run_splits(self._split_for_bisection(trials))
            return
        self._fail_trials(trials, f"batch dispatch raised: {err!r}")
        if self._bisect:
            # Bisection leaf: the poison trial is isolated and contained. A
            # systemic error (every leaf failing, no completed dispatch in
            # between) must not FAIL the study trial by trial: consecutive
            # leaves share a bounded budget, then the error surfaces.
            self._leaf_strikes += 1
            if self._leaf_strikes >= self._strike_budget:
                raise err
            _logger.warning(f"trial {trials[0].number} quarantined after dispatch error: {err!r}")
            return
        raise err

    def _split_for_bisection(self, trials: list[Trial]) -> list[list[Trial]]:
        """How a failed (non-OOM) dispatch is split for containment: binary
        bisection here; the sharded executor splits along shard groups
        first."""
        mid = len(trials) // 2
        return [trials[:mid], trials[mid:]]

    def _run_splits(self, groups: list[list[Trial]]) -> None:
        """Run every group of a failed dispatch, containing the later groups
        even when an earlier group's containment re-raises (an unshrinkable
        OOM, a ``non_finite='raise'`` quarantine): every trial holds a
        terminal state before an error escapes. A device fault FAILs the
        groups not yet dispatched and re-raises at once."""
        errors: list[Exception] = []
        for i, group in enumerate(groups):
            if not group:
                continue
            try:
                self._run_batch(group)
            except Exception as err:  # graphlint: ignore[PY001] -- deferred re-raise: an early group's error must not strand the later groups RUNNING; the earliest error re-raises below once every group holds terminal states
                if _is_uncontained_device_fault(err):
                    rest = [t for g in groups[i + 1 :] for t in g]
                    self._fail_trials(rest, f"device fault in the dispatch: {err!r}")
                    raise
                errors.append(err)
        if errors:
            raise errors[0]

    def _tell_batch(self, trials: list[Trial], values: np.ndarray, finite: np.ndarray) -> None:
        study = self._study
        clip = self._non_finite == "clip"
        poisoned: list[int] = []
        for i, trial in enumerate(trials):
            if study._stop_flag:
                # Study.stop() mid-batch: the evaluated remainder is FAILed,
                # never COMPLETE past the budget, never RUNNING. break, not
                # return: under non_finite='raise' a stop fired by a
                # quarantine callback must not swallow the raise below.
                self._fail_trials(trials[i:], "study stopped (Study.stop()) before this trial was told")
                break
            value = values[i]
            if clip or bool(finite[i]):
                # Deliberately unskipped: a survivor reaping this trial
                # surfaces as UpdateFinishedTrialError, where
                # skip_if_finished would hand back the reaper's state as if
                # it were ours. Any tell that returns is ours (a FAIL the
                # tell path converted to included), so callbacks fire.
                try:
                    if np.ndim(value) == 0:
                        frozen = study.tell(trial, float(value))
                    else:
                        frozen = study.tell(trial, [float(x) for x in np.asarray(value)])
                except UpdateFinishedTrialError:
                    # The reaper owns the terminal state and notified for it.
                    continue
                if frozen.state == TrialState.COMPLETE and not finite[i]:
                    _logger.warning(
                        f"trial {trial.number} returned a non-finite value; "
                        "completed with clipped (nan_to_num) values under "
                        "non_finite='clip'."
                    )
                self._notify(frozen)
            else:
                poisoned.append(trial.number)
                telemetry.count("executor.quarantine")
                self._fail_trials(
                    [trial],
                    f"non-finite objective value {np.asarray(value)!r} quarantined "
                    f"(non_finite={self._non_finite!r})",
                )
        if poisoned and self._non_finite == "raise":
            raise NonFiniteObjectiveError(
                f"trials {poisoned} returned non-finite objective values "
                "(quarantined as FAIL before raising)"
            )

    def _fail_trials(self, trials: Sequence[Trial], reason: str) -> None:
        """FAIL each trial (its ``fail_reason`` first), then notify. The
        tell-path sibling of ``storages/_heartbeat.py::
        fail_and_notify_trials``: same reason-then-CAS order and
        ``UpdateFinishedTrialError`` race contract, notified through
        ``study.tell`` and this run's callbacks."""
        study = self._study
        storage_error: Exception | None = None
        to_notify: list["FrozenTrial"] = []
        for trial in trials:
            # A survivor may have reaped this trial since the dispatch:
            # losing that race is fine, double-finishing or double-notifying
            # is not. The attr write and the unskipped tell both surface it
            # as UpdateFinishedTrialError, and this worker skips the trial.
            try:
                try:
                    study._storage.set_trial_system_attr(trial._trial_id, "fail_reason", reason)
                except UpdateFinishedTrialError:
                    raise  # race lost: handled by the outer except
                except Exception as err:  # graphlint: ignore[PY001] -- the reason attr is diagnostics; a blip on it must not skip the FAIL tell below (losing the diagnostic is recoverable, stranding the trial RUNNING is not)
                    _logger.warning(
                        f"writing fail_reason for trial {trial.number} raised "
                        f"{err!r}; failing the trial without it."
                    )
                frozen = study.tell(trial, state=TrialState.FAIL)
            except UpdateFinishedTrialError:
                continue
            except Exception as err:  # graphlint: ignore[PY001] -- containment must visit every trial: a storage blip on one tell must not abort the loop and strand the rest RUNNING; the first error re-raises below (user callback errors still propagate, parity with the serial loop)
                if storage_error is None:
                    storage_error = err
                _logger.warning(
                    f"failing trial {trial.number} raised {err!r}; continuing "
                    "so the rest of the batch is not stranded RUNNING."
                )
                continue
            _logger.warning(f"Trial {trial.number} failed: {reason}")
            to_notify.append(frozen)
        # Notify only once every trial holds a terminal state: a callback
        # that raises must not abort this loop and leave trials RUNNING.
        for frozen in to_notify:
            self._notify(frozen)
        if storage_error is not None:
            raise storage_error

    def _notify(self, frozen: "FrozenTrial") -> None:
        """Fire the run's callbacks for one finished trial; every terminal
        path goes through here, as in the serial loop."""
        if flight.enabled():
            flight.trial_event("tell", frozen.number, frozen.state.name)
        for callback in self._callbacks:
            callback(self._study, frozen)
