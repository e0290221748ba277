"""Fault-injection kit (port of the storage and sampler parts of
``optuna_tpu/testing/fault_injection.py``).

* :class:`FaultPlan` / :class:`FaultInjectorStorage` — a transparent
  :class:`BaseStorage` proxy that injects transient exceptions, latency
  spikes, and hard "worker died mid-call" kills, driven by per-method
  probability and/or an explicit call-index schedule. Faults strike *before*
  the backing call executes, so a retried call is semantically safe — which
  is exactly the contract :class:`~optuna_tpu_torch.storages._retry.RetryingStorage`
  needs to replay them.
* Sampler chaos (:mod:`optuna_tpu_torch.samplers._resilience` is the layer
  under test): :class:`PathologicalHistoryPlan` seeds a study with the
  degenerate histories that NaN-poison unguarded samplers (all-identical
  params, constant values, ``±inf``/1e308 values, duplicated retry clones,
  single-trial history — :data:`PATHOLOGICAL_HISTORY_PLANS` is the matrix),
  and :class:`FaultySampler` raises / hangs / proposes NaN at the n-th
  relative suggestion.

* Device-dispatch chaos (:mod:`optuna_tpu_torch.parallel.executor` is the
  layer under test): :class:`FaultyVectorizedObjective` poisons, crashes,
  runs out of memory, kills or hangs chosen dispatches of a batched
  objective, and :class:`FakeResourceExhaustedError` is the OOM stand-in.

* Preemption and journal chaos (:mod:`optuna_tpu_torch.checkpoint` and the
  scan loop's resume are the layers under test): :class:`CheckpointChaosPlan`
  kills a scan study mid-chunk-sync and resumes it
  (:data:`CHECKPOINT_CHAOS_MATRIX` maps every loop checkpoint event to its
  scenario), :func:`tear_journal_tail` leaves the torn record a crash
  mid-append leaves, and :func:`plant_stale_lock` the lockfile a killed
  worker leaves.

* Observability and control chaos (:mod:`optuna_tpu_torch.flight`,
  :mod:`~optuna_tpu_torch.device_stats`, :mod:`~optuna_tpu_torch.health`,
  :mod:`~optuna_tpu_torch.autopilot` and :mod:`~optuna_tpu_torch.slo` are
  the layers under test): :data:`FLIGHT_EVENT_CHAOS_MATRIX`,
  :data:`DEVICE_STAT_CHAOS_MATRIX`, :data:`HEALTH_CHECK_CHAOS_MATRIX`,
  :data:`AUTOPILOT_CHAOS_MATRIX` and :data:`SLO_CHAOS_MATRIX` (each equal to
  the reference's), the scenario plans :class:`DeviceStatChaosPlan`,
  :class:`HealthChaosPlan`, :class:`AutopilotChaosPlan` and
  :class:`SLOChaosPlan` with their ``*_plan()`` constructors, and
  :func:`plant_dead_worker`, the stale snapshot a killed worker leaves.

The pod, hub-fleet and lease chaos of the reference, and the checkpoint
matrix's ``warm_load`` row (a hub re-home), wait for ROADMAP A8a and A9.

Typical chaos test::

    plan = FaultPlan(transient_rate=0.1, seed=7)
    storage = RetryingStorage(
        FaultInjectorStorage(InMemoryStorage(), plan),
        RetryPolicy(max_attempts=10, sleep=lambda _: None),
        retry_non_idempotent=True,  # faults strike before the backend commits
    )
    study = optuna_tpu_torch.create_study(storage=storage)
    study.optimize(objective, n_trials=50)   # must match the fault-free run
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Collection, Mapping, Sequence

import numpy as np

from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages._base import BaseStorage, _ForwardingStorage
from optuna_tpu_torch.storages._retry import TransientStorageError

_logger = get_logger(__name__)


class SimulatedWorkerDeath(BaseException):
    """Raised by a scheduled kill: the 'process got SIGKILL'd mid-call' stand-in.

    Deliberately a ``BaseException`` (like ``SystemExit``): the optimize
    loop's objective-error handling catches ``Exception`` and would convert a
    mere ``Exception`` into a clean FAIL tell — but a dead worker never gets
    to tell, so the kill must punch through every handler and leave the trial
    RUNNING for heartbeat failover to find.
    """


@dataclass
class FaultPlan:
    """Declarative description of what to inject, and when.

    ``transient_rate``/``latency_rate`` are per-call probabilities (seeded —
    a plan replays identically); ``schedule`` and ``kill_schedule`` map a
    method name to the 0-based call indices (counted per method) that MUST
    fault, for deterministic scenarios. ``methods`` limits probabilistic
    faults to a subset (scheduled faults always apply); ``max_faults`` caps
    the total injected so a finite retry budget always wins eventually.
    """

    transient_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.01
    methods: frozenset[str] | None = None
    schedule: Mapping[str, Sequence[int]] = field(default_factory=dict)
    kill_schedule: Mapping[str, Sequence[int]] = field(default_factory=dict)
    max_faults: int | None = None
    seed: int = 0
    exception_factory: Callable[[str], Exception] = field(
        default=lambda method: TransientStorageError(
            f"injected transient fault in {method}"
        )
    )


# Chaos matrix for the replay-unsafe storage writes: every method whose
# blind replay can double-apply maps to the failure scenario the chaos suite
# must exercise against it. Deliberately a hand-written literal (not an
# import of ``storages._retry.REPLAY_UNSAFE_METHODS``): the matrix is the
# *test plan* for that set, and a new replay-unsafe write must show up here
# with a scenario (``tests/test_torch_storages.py`` checks the two agree).
REPLAY_UNSAFE_CHAOS_MATRIX: dict[str, str] = {
    "create_new_study": "inject transient before commit; a retry must not mint a twin study",
    "delete_study": "inject transient before commit; a retry must not raise KeyError",
    "create_new_trial": "inject transient before commit; a retry must not mint a twin trial",
    "create_new_trials": "inject transient before commit; a retry must not duplicate the batch",
    "set_trial_param": "inject transient before commit; a retry must not collide with the claim",
    "set_trial_state_values": "kill mid-claim; heartbeat failover must reap the RUNNING trial",
}


def replay_unsafe_chaos_plan(
    *, indices: Sequence[int] = (0,), seed: int = 0, max_faults: int | None = None
) -> FaultPlan:
    """A :class:`FaultPlan` that deterministically faults every replay-unsafe
    write at the given per-method call ``indices`` — the executable form of
    :data:`REPLAY_UNSAFE_CHAOS_MATRIX`, used by the storage-contract chaos
    suite so new registry entries are exercised without editing the test."""
    return FaultPlan(
        schedule={method: tuple(indices) for method in REPLAY_UNSAFE_CHAOS_MATRIX},
        seed=seed,
        max_faults=max_faults,
    )


class FaultInjectorStorage(_ForwardingStorage):
    """Wrap any storage and inject faults per a :class:`FaultPlan`.

    Thread-safe; per-method call counts and the injected-fault total are
    exposed as ``calls`` / ``faults_injected`` for assertions. All faults are
    raised *before* delegating, so the backing storage never observes a
    half-applied call and retries cannot double-apply.
    """

    def __init__(self, backend: BaseStorage, plan: FaultPlan | None = None) -> None:
        super().__init__(backend)
        self.plan = plan if plan is not None else FaultPlan()
        self.calls: dict[str, int] = {}
        self.faults_injected = 0
        self.kills_injected = 0
        self._rng = random.Random(self.plan.seed)
        self._mutex = threading.Lock()

    def _forward(self, method: str, *args: Any, **kwargs: Any) -> Any:
        delay = self._maybe_fault(method)
        if delay is not None:
            time.sleep(delay)
        return super()._forward(method, *args, **kwargs)

    def _maybe_fault(self, method: str) -> float | None:
        """Raise per the plan, or return a latency to sleep (outside the lock)."""
        plan = self.plan
        with self._mutex:
            index = self.calls.get(method, 0)
            self.calls[method] = index + 1
            if index in tuple(plan.kill_schedule.get(method, ())):
                self.kills_injected += 1
                raise SimulatedWorkerDeath(
                    f"scheduled worker death at {method} call #{index}"
                )
            if index in tuple(plan.schedule.get(method, ())):
                self.faults_injected += 1
                raise plan.exception_factory(method)
            if plan.methods is not None and method not in plan.methods:
                return None
            budget_open = plan.max_faults is None or self.faults_injected < plan.max_faults
            if (
                budget_open
                and plan.transient_rate > 0.0
                and self._rng.random() < plan.transient_rate
            ):
                self.faults_injected += 1
                raise plan.exception_factory(method)
            if plan.latency_rate > 0.0 and self._rng.random() < plan.latency_rate:
                return plan.latency_s
        return None


def _random_params(
    rng: "np.random.RandomState", search_space: Mapping[str, Any]
) -> dict[str, Any]:
    """Uniform params over a search space (host-side, for history seeding)."""
    from optuna_tpu_torch.distributions import CategoricalDistribution

    params: dict[str, Any] = {}
    for name, dist in search_space.items():
        if isinstance(dist, CategoricalDistribution):
            params[name] = dist.choices[rng.randint(len(dist.choices))]
        else:
            value = rng.uniform(dist.low, dist.high)
            params[name] = dist.to_external_repr(dist.to_internal_repr(value))
    return params


def _fixed_params(search_space: Mapping[str, Any]) -> dict[str, Any]:
    """One deterministic point (midpoint / first choice) of a search space."""
    from optuna_tpu_torch.distributions import CategoricalDistribution

    params: dict[str, Any] = {}
    for name, dist in search_space.items():
        if isinstance(dist, CategoricalDistribution):
            params[name] = dist.choices[0]
        else:
            value = 0.5 * (dist.low + dist.high)
            params[name] = dist.to_external_repr(dist.to_internal_repr(value))
    return params


@dataclass(frozen=True)
class PathologicalHistoryPlan:
    """One degenerate-history scenario the sampler resilience rings must
    absorb: :meth:`populate` seeds a study with ``n_trials`` COMPLETE trials
    whose params/values follow the pathology. Every plan in
    :data:`PATHOLOGICAL_HISTORY_PLANS` must leave every sampler able to
    finish a fresh trial budget with finite params and zero aborts
    (``tests/test_torch_runtime.py``).

    ``params_fn(index, rng, search_space)`` -> external-repr params;
    ``value_fn(index)`` -> the scalar objective value (replicated across
    objectives for multi-objective studies); ``clone_attrs`` additionally
    tags odd-indexed trials as retry clones of their predecessor
    (``failed_trial``/``retry_history``/``fixed_params``), the lineage shape
    ``RetryFailedTrialCallback`` produces.
    """

    name: str
    description: str
    n_trials: int
    params_fn: Callable[[int, "np.random.RandomState", Mapping[str, Any]], dict]
    value_fn: Callable[[int], float]
    clone_attrs: bool = False

    def populate(self, study: Any, search_space: Mapping[str, Any], *, seed: int = 0) -> None:
        from optuna_tpu_torch.trial._frozen import create_trial
        from optuna_tpu_torch.trial._state import TrialState

        rng = np.random.RandomState(seed)
        n_objectives = len(study.directions)
        for i in range(self.n_trials):
            params = self.params_fn(i, rng, search_space)
            system_attrs: dict[str, Any] = {}
            if self.clone_attrs and i % 2 == 1:
                system_attrs = {
                    "failed_trial": i - 1,
                    "retry_history": [i - 1],
                    "fixed_params": params,
                }
            study.add_trial(
                create_trial(
                    state=TrialState.COMPLETE,
                    params=params,
                    distributions=dict(search_space),
                    values=[self.value_fn(i)] * n_objectives,
                    system_attrs=system_attrs or None,
                )
            )


#: The degenerate histories every sampler must survive (a row per failure
#: matrix entry in ARCHITECTURE.md "Sampler resilience"). Duplicates come in
#: two flavors: every row identical (a Gram matrix of rank one) and
#: pairwise-duplicated retry clones carrying real retry lineage attrs.
PATHOLOGICAL_HISTORY_PLANS: tuple[PathologicalHistoryPlan, ...] = (
    PathologicalHistoryPlan(
        name="identical_params",
        description="every trial at the same point: the Gram matrix is rank one",
        n_trials=8,
        params_fn=lambda i, rng, space: _fixed_params(space),
        value_fn=lambda i: 0.1 * i,
    ),
    PathologicalHistoryPlan(
        name="constant_values",
        description="objective constant: zero-variance standardization/bandwidths",
        n_trials=8,
        params_fn=lambda i, rng, space: _random_params(rng, space),
        value_fn=lambda i: 0.0,
    ),
    PathologicalHistoryPlan(
        name="inf_values",
        description="±inf objectives: one inf poisons an unclipped mean",
        n_trials=8,
        params_fn=lambda i, rng, space: _random_params(rng, space),
        value_fn=lambda i: (float("inf"), float("-inf"), 1.0)[i % 3],
    ),
    PathologicalHistoryPlan(
        name="huge_values",
        description="±1e308 objectives: finite in f64, overflow in f32",
        n_trials=8,
        params_fn=lambda i, rng, space: _random_params(rng, space),
        value_fn=lambda i: (1e308, -1e308, 2.0)[i % 3],
    ),
    PathologicalHistoryPlan(
        name="retry_clones",
        description="B duplicated retry clones: pairwise-identical rows with lineage attrs",
        n_trials=8,
        params_fn=lambda i, rng, space: (
            _random_params(np.random.RandomState(1000 + i // 2), space)
        ),
        value_fn=lambda i: 0.05 * (i // 2),
        clone_attrs=True,
    ),
    PathologicalHistoryPlan(
        name="single_trial",
        description="one-observation history: degenerate splits and variances",
        n_trials=1,
        params_fn=lambda i, rng, space: _random_params(rng, space),
        value_fn=lambda i: 1.0,
    ),
)


class FaultySampler:
    """A sampler whose *relative* suggestions misbehave on schedule.

    Wraps any :class:`~optuna_tpu_torch.samplers._base.BaseSampler`; all knobs are
    keyed by the 0-based ``sample_relative`` call index (``suggests`` counts
    them): ``raise_at`` raises ``error_factory(index)``, ``hang_at`` sleeps
    ``hang_s`` seconds first (tripping a ``fit_deadline_s`` watchdog), and
    ``nan_at`` returns a NaN proposal for every non-categorical dimension —
    exactly what an unguarded ill-conditioned GP emits. ``force_relative``
    claims the intersection search space even when the wrapped sampler would
    not, so the faults actually fire over plain inner samplers.
    """

    def __init__(
        self,
        inner: Any,
        *,
        raise_at: Collection[int] = (),
        hang_at: Collection[int] = (),
        nan_at: Collection[int] = (),
        hang_s: float = 30.0,
        force_relative: bool = False,
        error_factory: Callable[[int], Exception] = lambda index: RuntimeError(
            f"injected sampler crash at suggest #{index}"
        ),
    ) -> None:
        self._inner = inner
        self.raise_at = frozenset(raise_at)
        self.hang_at = frozenset(hang_at)
        self.nan_at = frozenset(nan_at)
        self.hang_s = hang_s
        self.error_factory = error_factory
        self.suggests = 0
        self._force_relative = force_relative
        if force_relative:
            from optuna_tpu_torch.search_space import IntersectionSearchSpace

            self._intersection = IntersectionSearchSpace()

    def reseed_rng(self) -> None:
        self._inner.reseed_rng()

    def infer_relative_search_space(self, study: Any, trial: Any) -> dict:
        if self._force_relative:
            return {
                name: dist
                for name, dist in self._intersection.calculate(study).items()
                if not dist.single()
            }
        return self._inner.infer_relative_search_space(study, trial)

    def sample_relative(self, study: Any, trial: Any, search_space: dict) -> dict:
        from optuna_tpu_torch.distributions import CategoricalDistribution

        index = self.suggests
        self.suggests += 1
        if index in self.hang_at:
            time.sleep(self.hang_s)
        if index in self.raise_at:
            raise self.error_factory(index)
        if index in self.nan_at:
            return {
                name: (
                    dist.choices[0]
                    if isinstance(dist, CategoricalDistribution)
                    else float("nan")
                )
                for name, dist in search_space.items()
            }
        if self._force_relative:
            # The wrapped sampler never claimed this space; healthy calls
            # decline the relative proposal so dims resolve independently.
            return {}
        return self._inner.sample_relative(study, trial, search_space)

    def sample_independent(self, study: Any, trial: Any, name: str, dist: Any) -> Any:
        return self._inner.sample_independent(study, trial, name, dist)

    def before_trial(self, study: Any, trial: Any) -> None:
        self._inner.before_trial(study, trial)

    def after_trial(self, study: Any, trial: Any, state: Any, values: Any) -> None:
        self._inner.after_trial(study, trial, state, values)

    def __str__(self) -> str:
        return f"FaultySampler({self._inner})"


# ----------------------------------------------------- device-dispatch chaos


class FakeResourceExhaustedError(RuntimeError):
    """An allocation-failure stand-in: the executor classifies OOM by type
    (``torch.OutOfMemoryError``) or by the ``RESOURCE_EXHAUSTED`` text, so
    no allocator error needs constructing."""


#: Chaos matrix for the executor's non-finite quarantine policies: every
#: policy literal the executor accepts maps to the injection scenario the
#: chaos suite runs against it. A hand-written literal, not an import of
#: ``parallel.executor.NON_FINITE_POLICIES``: the tests hold the two key
#: sets equal, so a policy added without a chaos scenario fails them.
NON_FINITE_CHAOS_POLICIES: dict[str, str] = {
    "fail": "inject NaN at batch positions; those trials FAIL, the rest COMPLETE finite",
    "raise": "inject NaN; the executor quarantines as FAIL and then raises to the caller",
    "clip": "inject NaN; every trial COMPLETEs with finite (nan_to_num) values",
}


class FaultyVectorizedObjective:
    """A ``VectorizedObjective`` whose dispatches misbehave on schedule.

    Every knob is keyed by the 0-based **dispatch index** (counted per
    objective, the executor's bisection and halving re-dispatches included;
    ``dispatch_widths`` follows the recursion):

    ``nan_at``
        ``{dispatch: positions}``: the first float parameter column is set
        to NaN at those batch positions before the call, so the objective's
        output is NaN there and the executor's finite mask quarantines
        exactly those trials.
    ``raise_at`` / ``oom_at`` / ``kill_at`` / ``hang_at``
        Dispatch indices that raise ``error_factory(index)``, raise
        :class:`FakeResourceExhaustedError`, raise
        :class:`SimulatedWorkerDeath` (through every containment layer,
        leaving the batch RUNNING for heartbeat failover), or sleep
        ``hang_s`` seconds (tripping the executor's dispatch deadline).
    ``oom_above``
        Width threshold: any dispatch wider than this raises the OOM
        stand-in, the knob behind "halve until it fits".
    ``raise_when``
        Host predicate over the packed params as numpy arrays; a persistent
        poison (``lambda p: (p["x"] > 0.9).any()``) follows the poison trial
        through bisection instead of striking a fixed dispatch.

    Faults strike before the wrapped objective runs. Reading the params for
    ``raise_when`` or ``nan_at`` is a host read of the card's tensors; the
    poisoned column goes back to the tensor's device.
    """

    def __init__(
        self,
        fn: Callable[[dict[str, Any]], Any],
        search_space: dict,
        *,
        nan_at: Mapping[int, Sequence[int]] | None = None,
        raise_at: Collection[int] = (),
        oom_at: Collection[int] = (),
        kill_at: Collection[int] = (),
        hang_at: Collection[int] = (),
        hang_s: float = 30.0,
        oom_above: int | None = None,
        raise_when: Callable[[dict[str, "np.ndarray"]], bool] | None = None,
        error_factory: Callable[[int], Exception] = lambda index: RuntimeError(
            f"injected dispatch crash at dispatch #{index}"
        ),
    ) -> None:
        from optuna_tpu_torch.parallel.vectorized import VectorizedObjective

        self._inner = VectorizedObjective(fn, search_space)
        self.fn = fn
        self.search_space = search_space
        self.nan_at = dict(nan_at or {})
        self.raise_at = frozenset(raise_at)
        self.oom_at = frozenset(oom_at)
        self.kill_at = frozenset(kill_at)
        self.hang_at = frozenset(hang_at)
        self.hang_s = hang_s
        self.oom_above = oom_above
        self.raise_when = raise_when
        self.error_factory = error_factory
        self.dispatches = 0
        self.dispatch_widths: list[int] = []

    def compiled(self, mesh=None, batch_axis="trials"):
        return self._inner.compiled(mesh, batch_axis)

    def guarded(self, mesh=None, batch_axis="trials", non_finite: str = "fail"):
        import torch

        inner = self._inner.guarded(mesh, batch_axis, non_finite)

        def _faulty(args: dict) -> Any:
            index = self.dispatches
            self.dispatches += 1
            width = int(next(iter(args.values())).shape[0]) if args else 0
            self.dispatch_widths.append(width)
            if index in self.kill_at:
                raise SimulatedWorkerDeath(f"scheduled worker death at dispatch #{index}")
            if index in self.oom_at or (self.oom_above is not None and width > self.oom_above):
                raise FakeResourceExhaustedError(
                    f"RESOURCE_EXHAUSTED: out of memory allocating a "
                    f"{width}-wide dispatch (injected)"
                )
            if index in self.raise_at:
                raise self.error_factory(index)
            positions = [p for p in self.nan_at.get(index, ()) if p < width]
            if self.raise_when is not None or positions:
                host = {k: v.detach().cpu().numpy() for k, v in args.items()}
                if self.raise_when is not None and self.raise_when(host):
                    raise self.error_factory(index)
            if index in self.hang_at:
                time.sleep(self.hang_s)
            if positions:
                name = next(k for k, v in host.items() if np.issubdtype(v.dtype, np.floating))
                column = host[name].copy()
                column[positions] = np.nan
                args = {**args, name: torch.as_tensor(column, device=args[name].device)}
            return inner(args)

        return _faulty


# ------------------------------------------------------------- sampler chaos


#: Chaos matrix for the sampler resilience layer's fallback policies: every
#: policy literal ``GuardedSampler`` and the executor accept maps to the
#: injection scenario the chaos suite runs against it (held equal to
#: ``samplers._resilience.FALLBACK_POLICIES`` by the tests).
FALLBACK_CHAOS_POLICIES: dict[str, str] = {
    "independent": "inject sampler raise/hang/NaN; the budget completes via "
    "independent sampling, fallback attrs on exactly the degraded trials",
    "raise": "inject sampler raise; the error surfaces to the caller after "
    "the fallback attr is recorded",
}


# -------------------------------------------------------- preemption chaos


#: The preemption scenario for every checkpoint event a loop counts
#: (``checkpoint.CHECKPOINT_EVENTS`` less ``warm_load``, the serve tier's
#: hub re-home, which comes with ROADMAP A9).
CHECKPOINT_CHAOS_MATRIX: dict[str, str] = {
    "write": "run a scan study over a journal storage; every chunk sync (and the startup "
    "sync) leaves a CRC-framed blob in the ckpt: ring and bumps the write counter",
    "write_error": "blip set_study_system_attr under FaultInjectorStorage exactly when the "
    "checkpoint write lands; the loop continues uncheckpointed and the error is counted",
    "restore": "kill the loop mid-chunk-sync (SimulatedWorkerDeath in-process); "
    "optimize_scan(resume=True) rebuilds the carry from the newest valid blob and "
    "reaches the fault-free twin's trials",
    "rejected": "garble a ring slot (bad base64 / torn CRC / wrong schema version) before "
    "the resume; the blob is skipped and counted, the surviving slot (or fallback) serves",
    "stale": "plant a valid blob whose n_told watermark trails the synced history by more "
    "than one write interval; the resume skips it as stale and recomputes",
    "fallback": "garble every ring slot; the resume counts the fallback, recomputes the "
    "carry from COMPLETE history, and still finishes the exact remaining budget",
}


@dataclass(frozen=True)
class CheckpointChaosPlan:
    """One deterministic preemption chaos scenario: a scan study over a
    durable (journal) storage, a kill mid-chunk-sync after
    :attr:`preempt_after_tells` budget-consuming tells, and a relaunch with
    ``optimize_scan(resume=True)``, with the outcome the acceptance test
    asserts: the resumed study completes exactly ``n_trials``
    budget-consuming tells, no trial is left RUNNING, no op token is told
    twice, and the trials equal the uninterrupted same-seed twin's. The
    corrupt-blob leg garbles :attr:`corrupt_slots` of the ``ckpt:`` ring
    before the resume and asserts every garbled blob is rejected and
    counted and the study still completes through the
    recompute-from-history fallback.

    ``preempt_after_tells`` lands *inside* a chunk sync (neither 0 nor a
    multiple of ``sync_every``): a chunk half-told at death exercises the
    dup-skip (already-told ops) and the adoption (token-stamped RUNNING
    strays) in the same resumed chunk.
    """

    n_trials: int = 96
    sync_every: int = 8
    n_startup_trials: int = 8
    seed: int = 11
    #: Budget-consuming tells after which the kill strikes: mid-chunk by
    #: construction (see the class docstring).
    preempt_after_tells: int = 44
    #: Ring slots to garble before the resume in the corrupt-blob leg.
    corrupt_slots: tuple[int, ...] = (0, 1)

    @property
    def preempt_chunk(self) -> int:
        """The chunk index the kill lands in (0-based, after startup)."""
        return (self.preempt_after_tells - self.n_startup_trials) // self.sync_every


def checkpoint_chaos_plan() -> CheckpointChaosPlan:
    """The default :class:`CheckpointChaosPlan`: kill a 96-trial scan study
    44 tells in (mid-chunk), resume, and compare to the uninterrupted twin."""
    return CheckpointChaosPlan()


def tear_journal_tail(file_path: str, keep_bytes: int = 7) -> int:
    """Truncate the journal's final record mid-line: a crash during append.

    Keeps ``keep_bytes`` bytes of the last record (no trailing newline), the
    on-disk state a power cut between ``write`` and ``fsync`` leaves behind.
    Returns the number of bytes removed. No-op (returns 0) on an empty file.
    """
    with open(file_path, "rb+") as f:
        data = f.read()
        if not data:
            return 0
        body = data.rstrip(b"\n")
        last_nl = body.rfind(b"\n")
        record_start = last_nl + 1  # 0 when the file holds a single record
        keep = min(record_start + keep_bytes, len(body) - 1 if len(body) else 0)
        f.truncate(keep)
        removed = len(data) - keep
    _logger.info(f"tore {removed} bytes off the journal tail of {file_path}")
    return removed


def plant_stale_lock(file_path: str, age_s: float = 3600.0, *, flavor: str = "symlink") -> str:
    """Create the lockfile a killed worker would leave: already held, with
    an mtime ``age_s`` seconds in the past so grace-period takeover applies.

    ``flavor`` matches the two lock primitives in
    :mod:`optuna_tpu_torch.storages.journal._file`: ``"symlink"``
    (JournalFileSymlinkLock) or ``"open"`` (JournalFileOpenLock).
    Returns the lockfile path.
    """
    from optuna_tpu_torch.storages.journal._file import LOCK_FILE_SUFFIX

    lockfile = file_path + LOCK_FILE_SUFFIX
    if flavor == "symlink":
        os.symlink(file_path, lockfile)
        stamp = time.time() - age_s
        os.utime(lockfile, (stamp, stamp), follow_symlinks=False)
    elif flavor == "open":
        fd = os.open(lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
        stamp = time.time() - age_s
        os.utime(lockfile, (stamp, stamp))
    else:
        raise ValueError(f"Unknown lock flavor {flavor!r} (want 'symlink' or 'open').")
    return lockfile


# ------------------------------------------------ observability and control chaos


## Acceptance matrix for the flight recorder's event kinds: every kind the
# recorder accepts (``flight.py::EVENT_KINDS``) maps to the scenario that
# proves it fires. A hand-written literal equal to the reference's (the
# tests hold both to ``EVENT_KINDS``).
FLIGHT_EVENT_CHAOS_MATRIX: dict[str, str] = {
    "phase": "fault-free study; ask/dispatch/tell spans recorded per trial/batch",
    "trial": "fault-free study; one ask + one tell instant per trial, numbered",
    "containment": "NaN slot + crash + storage blip; events match the plan in order",
    "rpc.client": "flight-enabled proxy client; every RPC records a client span",
    "rpc.server": "two-process study; server handler spans carry the client trace id",
    "jit.compile": "first vectorized dispatch grows the jit cache; compile event + gauge",
    "jit.retrace": "a second batch shape grows the cache again; retrace event + gauge",
    "gauge": "device-gauge sample records HBM stats where the backend exposes them",
    "postmortem": "terminal batch failure / sampler degrade flushes a bounded dump",
    "flow": "coalesced ask burst + ready-queue pops; the Chrome export carries matched "
    "fan-in and fan-out arrow endpoints (ph s/f, same id), schema-validated",
}


# Chaos matrix for the device-stat channel: every stat name the harvest
# accepts (``device_stats.py::DEVICE_STATS``) maps to the injection scenario
# that proves it reports. A hand-written literal equal to the reference's.
DEVICE_STAT_CHAOS_MATRIX: dict[str, str] = {
    "gp.ladder_rung": "inject a rank-deficient Gram; the in-graph ladder reports rung >= 1, "
    "the well-conditioned twin reports 0",
    "gp.fit_iterations": "run a fused GP ask; the stats struct reports >= 1 fit iterations",
    "gp.proposal_fallback_coords": "fault-free fused ask; the count matches the plan exactly (0 — "
    "no coordinate walked non-finite)",
    "gp.best_acq": "run a fused GP ask; the reported best acquisition value is finite",
    "gp.inducing_count": "run a sparse fused ask above the exact-size threshold; the reported "
    "count is >= 1 and <= the inducing capacity, the below-threshold twin never reports it",
    "gp.sparsity_ratio": "run a sparse fused ask with n real rows and capacity m < n; the "
    "reported ratio equals m/n within f32 tolerance",
    "gp.inducing_swaps": "run a sparse scan chunk on a drifting objective; swap-ins report >= 0 "
    "and equal the SGPR rebuilds the chunk performed",
    "gp.sparse_heldout_err": "run a sparse scan chunk; the reported one-step-ahead residual is "
    "finite and non-negative (an exactly-predicted chunk reports ~0)",
    "executor.quarantined": "inject NaN at scheduled batch slots; the harvested total equals the "
    "plan's slot count exactly, the fault-free twin reports 0",
    "scan.rank1_updates": "run a fault-free scan study on a well-conditioned objective; updates "
    "equal the ingested tells and refactorizations stay 0 after warm-up",
    "scan.refactorizations": "append an exact-duplicate design row under a deterministic noise "
    "floor; the in-graph pivot check falls back to the full ladder refactorization",
    "scan.quarantined": "inject NaN objective slots inside a scan chunk; the harvested total "
    "equals the plan's slot count, each slot told FAIL at sync, the fault-free twin reports 0",
    "scan.chunk_fill": "fault-free scan chunk; the fill equals the chunk length (quarantined "
    "chunks fill short by exactly the quarantined count)",
    "shard.width": "fault-free sharded batch; the stat equals ceil(B / trials-shards) exactly",
    "shard.quarantined": "inject NaN at slots owned by one shard; the harvested total equals "
    "the plan's slot count, the fault-free twin reports 0",
    "shard.contained_groups": "inject a one-dispatch poison crash into a multi-shard batch; "
    "per-shard containment re-dispatches every shard group and the count equals the group count",
}


@dataclass(frozen=True)
class DeviceStatChaosPlan:
    """One deterministic device-stat chaos scenario: which batch slots to
    NaN-poison, how to build the rank-deficient Gram the jitter ladder must
    resolve, and the exact stats the device channel must report
    (``the device-stat chaos tests`` asserts against these, the
    executable form of :data:`DEVICE_STAT_CHAOS_MATRIX`).

    The Gram injection targets the in-graph tap directly
    (:func:`~optuna_tpu_torch.samplers._resilience.ladder_cholesky_with_rung`
    under jit) rather than riding a GP fit: the resilience rings upstream —
    duplicate-row collapse, the MAP fit's non-finite loss guard — exist
    precisely to keep real fits away from singular factorizations, so a
    deterministic rung >= 1 needs the raw rank-deficient matrix the jitter
    ladder's tests use (an outer product: exactly singular, and a bare
    f32 Cholesky hands back NaN for it without raising).
    """

    nan_slots: tuple[int, ...] = (1, 2)
    batch_size: int = 4
    n_trials: int = 4
    gram_size: int = 8
    expected_fallback_coords: int = 0
    min_ladder_rung: int = 1

    @property
    def expected_quarantined(self) -> int:
        return len(self.nan_slots)

    def rank_deficient_gram(self) -> "np.ndarray":
        """Exactly singular PSD matrix (rank one, no diagonal noise): the
        Gram a bare Cholesky silently NaNs on."""
        v = np.linspace(1.0, 2.0, self.gram_size, dtype=np.float32)
        return np.outer(v, v)

    def healthy_gram(self) -> "np.ndarray":
        """The well-conditioned twin: the ladder's happy path, rung 0."""
        return (
            self.rank_deficient_gram()
            + np.eye(self.gram_size, dtype=np.float32)
        )


def device_stat_chaos_plan() -> DeviceStatChaosPlan:
    """The default :class:`DeviceStatChaosPlan` the chaos suite runs —
    two NaN slots in a four-wide batch, an 8x8 rank-one Gram."""
    return DeviceStatChaosPlan()


# ------------------------------------------------------- study-doctor chaos


# Chaos matrix for the study doctor's checks: every check id
# (``health.py::HEALTH_CHECKS``) maps to the fault scenario that proves it
# fires. A hand-written literal equal to the reference's: an unproven doctor
# check certifies sick studies healthy.
HEALTH_CHECK_CHAOS_MATRIX: dict[str, str] = {
    "study.stagnation": "seed a constant-value history + a never-improving objective past "
    "the window; the doctor flags stagnation, the improving twin stays clean",
    "sampler.fallback_storm": "inject NaN proposals at storm rate via FaultySampler under "
    "GuardedSampler; the fallback counters cross the rate threshold",
    "sampler.duplicate_proposals": "seed pairwise-duplicated retry-clone history; the exact-"
    "duplicate rate crosses the threshold",
    "executor.quarantine_rate": "inject NaN batch slots; quarantine counters cross the "
    "budget-loss rate threshold",
    "executor.dispatch_timeouts": "publish a worker snapshot carrying dispatch_timeout "
    "strikes at the budget; the strike count alone flags",
    "jit.retrace_churn": "publish jit totals with retraces_after_first past the churn "
    "floor; the labels are named in the finding",
    "gp.ladder_escalation": "publish device.gp.ladder_rung.max at the escalation rung; "
    "the gauge alone flags",
    "gp.sparse_degraded": "publish device.gp.sparse_heldout_err.last at/above the "
    "standardized-unit threshold; the gauge alone flags, the well-covered twin stays clean",
    "worker.dead": "plant a stale worker snapshot (plant_dead_worker — what a SIGKILL'd "
    "worker leaves); liveness derives dead from snapshot age vs interval",
    "shard.imbalance": "publish shard.trials.<coord> throughput gauges with one shard >= 2x "
    "below the mesh median; the lagging coordinate is named, the balanced twin stays clean",
    "service.backpressure": "force the suggestion service's shed ladder with an overload "
    "burst (ServiceChaosPlan); the doctor reports the exact per-policy shed counts",
    "service.ready_queue_starved": "drive asks with ask-ahead disabled (or perpetually "
    "invalidated); the miss rate crosses the starvation threshold, the speculating twin stays clean",
    "service.slo_burn": "overload burst under a floor-level serve.ask target (SLOChaosPlan): "
    "every ask violates, both burn windows cross critical, the finding carries the exact "
    "violation counts through the fleet channel, and the compliant twin stays clean",
    "service.hub_dead": "SIGKILL one FakeHubFleet hub mid-burst (HubChaosPlan): its -serve "
    "snapshot goes stale past grace, the doctor names the dead hub, and the healthy-fleet "
    "twin stays clean",
    "checkpoint.stale": "garble every ckpt: ring slot before a resume (CheckpointChaosPlan's "
    "corrupt-blob leg): each blob is CRC-rejected and counted, the resume falls back to the "
    "recompute-from-history path, and the doctor reports the rejection totals; the "
    "clean-resume twin stays unflagged",
    "service.hub_flapping": "bounce a study's lease between two hubs (repeated kill/heal, "
    "LeaseChaosPlan's flap leg): three takeovers land in the lease history inside the "
    "window, the doctor names both hubs, and the single-takeover twin stays clean",
    "service.hub_zombie_fenced": "push tells through a partitioned owner (the zombie); "
    "its stale-epoch writes are fenced and fleet.fenced_write lands in the -serve "
    "snapshot, so the doctor reports the zombie before operators chase ghost writes",
    "service.partition_suspected": "take over a study's lease while the deposed hub's "
    "-serve snapshot is still fresh (alive behind the partition): the doctor flags "
    "partition-not-crash; the crashed-hub twin (stale snapshot) reports hub_dead instead",
}


@dataclass(frozen=True)
class HealthChaosPlan:
    """One deterministic study-doctor chaos scenario: the combined faults to
    inject (NaN batch slots, pathological seeded history, storage blips, a
    dead worker's stale snapshot) and the exact finding ids the doctor must
    report for them — the doctor's chaos tests assert the report's
    check-id set equals :attr:`expected_findings` exactly, and the
    fault-free twin reports healthy (the executable form of
    :data:`HEALTH_CHECK_CHAOS_MATRIX`'s combined row).

    The numbers are chosen to clear the doctor's documented thresholds with
    margin: ``n_trials`` completed tells on a never-improving objective over
    a constant-value seeded history crosses the stagnation window;
    ``sampler_nan_at`` yields a fallback rate past the storm threshold;
    ``nan_slots`` quarantines past the budget-loss rate; the planted worker
    is ``dead_worker_age_s`` stale — orders of magnitude past the liveness
    grace.
    """

    n_trials: int = 24
    batch_size: int = 8
    seeded_history_plan: int = 1  # PATHOLOGICAL_HISTORY_PLANS index: constant_values
    nan_slots: Mapping[int, Sequence[int]] = field(
        default_factory=lambda: {0: (1, 2), 1: (0,), 2: (3,)}
    )
    sampler_nan_at: tuple[int, ...] = tuple(range(2, 12))
    storage_blip_schedule: Mapping[str, Sequence[int]] = field(
        default_factory=lambda: {
            "get_all_trials": (0, 1),
            "set_study_system_attr": (0,),
        }
    )
    dead_worker_id: str = "chaos-host-dead"
    dead_worker_age_s: float = 3600.0
    expected_findings: tuple[str, ...] = (
        "study.stagnation",
        "sampler.fallback_storm",
        "executor.quarantine_rate",
        "worker.dead",
    )

    @property
    def expected_quarantined(self) -> int:
        return sum(len(slots) for slots in self.nan_slots.values())

    def storage_fault_plan(self) -> FaultPlan:
        """The storage blips (transient, pre-commit, retry-safe) riding
        along: the reporter's attr writes and the aggregator's reads must
        survive them under RetryingStorage without changing the findings."""
        return FaultPlan(schedule=dict(self.storage_blip_schedule))


def health_chaos_plan() -> HealthChaosPlan:
    """The default :class:`HealthChaosPlan` the chaos suite runs — four NaN
    slots across three batches, eight NaN sampler proposals, a constant
    seeded history, three storage blips, one hour-stale worker."""
    return HealthChaosPlan()


def plant_dead_worker(
    study: Any, worker_id: str = "chaos-host-dead", age_s: float = 3600.0
) -> dict:
    """Publish the stale health snapshot a SIGKILL'd worker would leave:
    its last successful publish, ``age_s`` seconds old, never refreshed
    (the health-reporter analog of :func:`plant_stale_lock`). Returns the
    snapshot planted. The counters are empty by design — a dead worker's
    finding must come from *staleness*, not from its counter payload
    contaminating the fleet rates."""
    from optuna_tpu_torch.health import DEFAULT_INTERVAL_S, WORKER_ATTR_PREFIX

    snapshot = {
        "worker": worker_id,
        "pid": 0,
        "seq": 1,
        "last_seen_unix": time.time() - age_s,
        "interval_s": DEFAULT_INTERVAL_S,
        "counters": {},
        "gauges": {},
        "histograms": {},
        "jit": {},
    }
    study._storage.set_study_system_attr(
        study._study_id, WORKER_ATTR_PREFIX + worker_id, snapshot
    )
    return snapshot


# -------------------------------------------------------------- autopilot chaos


# Chaos matrix for the autopilot's guarded actions: every action id
# (``autopilot.py::ACTIONS``) maps to the fault scenario that proves it fires
# once under cooldown, executes in ``mode="act"``, is only recorded in
# ``mode="observe"``, and rolls back when its finding does not improve. A
# hand-written literal equal to the reference's.
AUTOPILOT_CHAOS_MATRIX: dict[str, str] = {
    "sampler.restart": "seed a constant history + a never-improving objective past the "
    "stagnation window; the action fires once, pins an exploration burst, and — the "
    "objective never improving — rolls back after rollback_after finished trials",
    "sampler.pin_independent": "inject NaN proposals at storm rate via FaultySampler under "
    "GuardedSampler; the action fires once and the pin provably stops the storm (fewer "
    "inner-sampler suggests than the schedule would have poisoned)",
    "executor.pin_shapes": "record retrace churn past the threshold (jit totals channel); "
    "the action freezes the executor's requested width at the compiled width and the undo "
    "restores it",
    "executor.tighten_regrowth": "inject NaN batch slots past the quarantine-rate "
    "threshold; the action stretches the probationary regrowth streak on the live executor",
    "service.shed_earlier": "count shed asks past the backpressure threshold against a "
    "live hub; the action halves the ShedPolicy thresholds, doubles ready-queue prewarm, "
    "and the undo restores both exactly",
    "gp.densify": "publish device.gp.sparse_heldout_err.last past the degradation "
    "threshold against a study carrying a scan-loop control dict; the action doubles its "
    "inducing capacity (exact-posterior fallback once at cap) and the undo restores the "
    "previous thresholds exactly",
}


@dataclass(frozen=True)
class AutopilotChaosPlan:
    """One deterministic autopilot chaos scenario: the
    :class:`HealthChaosPlan` fault mix trimmed to the checks with actuators
    (stagnation via seeded constant history + never-improving objective,
    fallback storm via scheduled NaN proposals, an OOM/quarantine pattern
    via NaN batch slots) plus per-action expectations —
    ``tests/test_torch_autopilot.py`` asserts, under ``mode="act"``, that
    exactly :attr:`expected_actions` fire (once each: the cooldown is the
    storm guard), each is flight-recorded/attr-mirrored, the never-helped
    stagnation action rolls back, and the study drains with zero RUNNING;
    the ``mode="observe"`` twin records the identical decision set while
    staying bit-identical to the autopilot-off twin; the disabled twin
    allocates nothing over 10k boundary calls.

    Thresholds cleared with margin: ``n_trials`` never-improving completes
    over a constant seeded history cross ``stagnation_window``;
    ``sampler_nan_at`` crosses the fallback-storm rate while leaving most
    of its schedule unspent for the pin to provably cancel; ``nan_slots``
    cross the quarantine rate without dominating the stagnation window
    (the containment guard must not suppress the stagnation finding here).
    """

    n_trials: int = 24
    batch_size: int = 8
    seeded_history_plan: int = 1  # PATHOLOGICAL_HISTORY_PLANS index: constant_values
    stagnation_window: int = 8
    nan_slots: Mapping[int, Sequence[int]] = field(
        default_factory=lambda: {0: (1, 2), 1: (0,)}
    )
    sampler_nan_at: tuple[int, ...] = tuple(range(2, 40))
    cooldown_s: float = 3600.0
    rollback_after: int = 8
    pin_trials: int = 64
    budget: int = 8
    expected_actions: tuple[str, ...] = (
        "sampler.restart",
        "sampler.pin_independent",
        "executor.tighten_regrowth",
    )
    #: The action whose finding provably cannot improve (the objective
    #: never improves), so the acceptance test asserts its rollback.
    rollback_action: str = "sampler.restart"

    @property
    def expected_quarantined(self) -> int:
        return sum(len(slots) for slots in self.nan_slots.values())


def autopilot_chaos_plan() -> AutopilotChaosPlan:
    """The default :class:`AutopilotChaosPlan` the chaos suite runs — a
    constant seeded history under a never-improving objective, a 38-deep
    NaN-proposal schedule, three NaN batch slots, hour-long cooldowns."""
    return AutopilotChaosPlan()


# ------------------------------------------------------------------ SLO chaos


# Chaos matrix for the SLO engine's objectives: every id
# (``slo.py::SLO_SPECS``) maps to the burn scenario that proves it can trip.
# A hand-written literal equal to the reference's.
SLO_CHAOS_MATRIX: dict[str, str] = {
    "serve.ask.latency": "overload burst under a floor-level target: every serve.ask "
    "observation violates, burn crosses critical, service.slo_burn fires with the exact "
    "violation count and the shed thresholds halve",
    "storage.op.latency": "latency-injected storage ops (FaultPlan latency_rate) under a "
    "floor-level target burn the budget; the uninjected twin stays compliant",
    "dispatch.latency": "a slow objective dispatch under a floor-level target burns; the "
    "default 30s target stays compliant on the same run",
    "tell.latency": "slow tells under a floor-level target burn the budget; the fault-free "
    "twin at the default target stays compliant",
    "scan.chunk.latency": "a scan chunk under a floor-level target burns; the default "
    "target stays compliant on the same chunk timings",
}


@dataclass(frozen=True)
class SLOChaosPlan:
    """One deterministic SLO-burn chaos scenario: an overload burst of
    serve-path asks evaluated against a *floor-level* latency target
    (every real observation violates — no sleeps, no timing races), and
    the exact outcome the acceptance test asserts
    (the SLO chaos tests): the sketch p99 crosses the spec, both
    burn windows cross :data:`optuna_tpu_torch.slo.BURN_CRITICAL`, the doctor
    reports ``service.slo_burn`` with ``bad == burst_asks`` through the
    fleet channel, the shed thresholds halve via the policy's SLO feed, the
    shed events carry rung/depth/stale, and the Perfetto export holds at
    least one fan-in and one fan-out flow edge. The fault-free twin runs
    the same burst against the *default* targets and reports every SLO
    compliant; the disabled twin records nothing over
    ``disabled_calls`` span entries with a bounded heap.
    """

    n_clients: int = 4
    burst_asks: int = 12
    harsh_target_s: float = 1e-9
    window_s: float = 60.0
    objective: float = 0.99
    quantile: float = 0.99
    disabled_calls: int = 10_000

    def harsh_spec(self):
        """The floor-level ``serve.ask.latency`` spec the burst must burn."""
        from optuna_tpu_torch.slo import SLOSpec

        return SLOSpec(
            "serve.ask.latency",
            "serve.ask",
            self.quantile,
            self.harsh_target_s,
            self.objective,
            self.window_s,
        )


def slo_chaos_plan() -> SLOChaosPlan:
    """The default :class:`SLOChaosPlan` the chaos suite runs — a 12-ask
    burst from 4 clients against a 1ns serve.ask target."""
    return SLOChaosPlan()
