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

* Serve-tier chaos (:mod:`optuna_tpu_torch.storages._grpc` is the layer
  under test): :data:`SHED_CHAOS_POLICIES`, :data:`HUB_CHAOS_MATRIX` and
  :data:`LEASE_CHAOS_MATRIX` with the plans :class:`ServiceChaosPlan`,
  :class:`HubChaosPlan` and :class:`LeaseChaosPlan`; :func:`mount_dispatch`,
  one storage and service behind the server's request dispatcher (no
  ``grpc`` needed), with :func:`thin_client_ask` over it; :class:`FakeHubFleet`,
  N fleet hubs over one storage mounted so, and :class:`SocketHubFleet`,
  its real-socket twin.

* Pod chaos (:mod:`optuna_tpu_torch.parallel.sharded` and
  :mod:`~optuna_tpu_torch.parallel.ici_journal` are the layers under
  test): :class:`FakePodBus`, N ``IciJournalBackend`` s whose all-gather
  rendezvous at a thread barrier (the lockstep of a real collective), and
  :class:`ShardChaosPlan` / :func:`shard_chaos_plan`, NaN rows on one shard
  and a killed worker in one sharded study, with the outcome the
  acceptance test asserts.

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


# ------------------------------------------------------------- pod-bus chaos


class FakePodBus:
    """Lockstep all-gather across N in-process ranks (threads): the
    multi-rank seam of :class:`~optuna_tpu_torch.parallel.ici_journal.
    IciJournalBackend` driven without a process group.

    Gathers rendezvous at a barrier exactly like a collective: every worker
    must reach ``exchange()`` the same number of times or the round times
    out, the discipline real collectives impose. Pod scenarios
    (``optimize_sharded``'s leader/follower lockstep, a rank dying
    mid-study) are injectable faults of the kit, not test-local plumbing.
    """

    def __init__(self, n_workers: int, buffer_bytes: int = 1 << 16) -> None:
        from optuna_tpu_torch.parallel.ici_journal import IciJournalBackend

        self.n = n_workers
        self.workers = [IciJournalBackend(buffer_bytes=buffer_bytes) for _ in range(n_workers)]
        self._slots: list["np.ndarray | None"] = [None] * n_workers
        self._barrier = threading.Barrier(n_workers, timeout=30)
        for idx, worker in enumerate(self.workers):
            worker._allgather = self._make_gather(idx)  # type: ignore[method-assign]

    def _make_gather(self, idx: int):
        def gather(buf: "np.ndarray") -> "np.ndarray":
            self._slots[idx] = buf
            self._barrier.wait()  # all buffers staged
            out = np.stack([s for s in self._slots])  # rank order
            self._barrier.wait()  # all workers copied out before reuse
            return out

        return gather

    def lockstep(self, *fns) -> list:
        """Run one callable per worker concurrently; re-raise any failure
        (aborting the barrier so no peer hangs on a dead partner)."""
        assert len(fns) == self.n
        results: list = [None] * self.n
        errors: list = [None] * self.n

        def run(i: int) -> None:
            try:
                results[i] = fns[i]()
            except BaseException as e:  # lockstep trampoline: a worker death (BaseException by design) must abort the barrier so peers fail fast instead of hanging; every error re-raises on the driving thread below
                errors[i] = e
                self._barrier.abort()

        threads = [threading.Thread(target=run, args=(i,)) for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # Prefer the ROOT fault: an abort makes the bystanders fail with
        # BrokenBarrierError, and re-raising a bystander's symptom would mask
        # the injected fault whenever the failing worker has a higher index.
        for e in errors:
            if e is not None and not isinstance(e, threading.BrokenBarrierError):
                raise e
        for e in errors:
            if e is not None:
                raise e
        return results

    def step(self, per_worker_logs: list[list[dict]]) -> None:
        """One exchange round: every worker appends its ops and reaches the
        collective together."""

        def work(worker, logs):
            worker._pending.extend(logs)
            worker.exchange()

        self.lockstep(*[(lambda w=w, logs=logs: work(w, logs)) for w, logs in zip(self.workers, per_worker_logs)])


@dataclass(frozen=True)
class ShardChaosPlan:
    """One deterministic chaos scenario for ``optimize_sharded``: NaN rows
    owned by one trials shard, a worker killed mid-dispatch (its stale
    health snapshot planted under a mesh-coordinate worker id), and the
    doctor findings and containment outcome the acceptance test asserts:
    the executable form of the FakePodBus row of
    :data:`HEALTH_CHECK_CHAOS_MATRIX` and the ``shard.*`` rows of
    :data:`DEVICE_STAT_CHAOS_MATRIX`.

    Geometry: a ``{'trials': 4, 'model': 2}`` mesh with ``batch_size`` = 8,
    two rows a shard, so ``nan_slots`` (0, 1) both land on shard t0 and the
    other shards' rows stay clean. A test on fewer ranks passes its own
    geometry (``ShardChaosPlan(mesh_trials=2, mesh_model=2, batch_size=4)``
    keeps two rows a shard).
    """

    mesh_trials: int = 4
    mesh_model: int = 2
    batch_size: int = 8
    n_trials: int = 24
    nan_slots: Mapping[int, Sequence[int]] = field(default_factory=lambda: {0: (0, 1)})
    # The LAST batch's dispatch: by then every trial of the budget has been
    # created and suggested, so the survivor's drain (reaped clones and NaN
    # retries, fixed_params pinned) re-runs the fault-free draw sequence
    # and needs no fresh draws after the death.
    kill_dispatch: int = 2
    dead_worker_coord: str = "t0m0"
    dead_worker_age_s: float = 3600.0
    expected_findings: tuple[str, ...] = ("worker.dead",)

    @property
    def expected_quarantined(self) -> int:
        return sum(len(slots) for slots in self.nan_slots.values())

    @property
    def dead_worker_id(self) -> str:
        return f"chaos-deadhost-0-{self.dead_worker_coord}"


def shard_chaos_plan() -> ShardChaosPlan:
    """The default :class:`ShardChaosPlan`: two NaN rows on shard t0 of a
    4 x 2 mesh, one killed worker at mesh coordinate t0m0."""
    return ShardChaosPlan()


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

    Faults strike before the wrapped objective runs. Over a mesh (the
    executor's dispatch passes ``upload``) a raise, an OOM or a hang strikes
    in this rank's upload, inside the dispatch's status boundary, as a fault
    of the objective would, so every rank agrees on it; a kill strikes at
    once, on every rank. Reading the params for
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

        def _faulty(args: dict, upload: Callable | None = None) -> Any:
            index = self.dispatches
            self.dispatches += 1
            width = int(next(iter(args.values())).shape[0]) if args else 0
            self.dispatch_widths.append(width)
            if index in self.kill_at:
                raise SimulatedWorkerDeath(f"scheduled worker death at dispatch #{index}")
            positions = [p for p in self.nan_at.get(index, ()) if p < width]
            host = None
            if self.raise_when is not None or positions:
                host = {k: v.detach().cpu().numpy() for k, v in args.items()}
            strike = self._strike(index, width, host)
            if positions:
                name = next(k for k, v in host.items() if np.issubdtype(v.dtype, np.floating))
                column = host[name].copy()
                column[positions] = np.nan
                args = {**args, name: torch.as_tensor(column, device=args[name].device)}
            if upload is None:
                strike()
                return inner(args)

            def _striking_upload(rows: dict) -> dict:
                strike()
                return upload(rows)

            return inner(args, upload=_striking_upload)

        return _faulty

    def _strike(self, index: int, width: int, host: "dict[str, np.ndarray] | None") -> Callable[[], None]:
        """What dispatch ``index`` suffers before its call: raise, OOM or
        hang, chosen now, in that order of precedence (a no-op if none)."""
        if index in self.oom_at or (self.oom_above is not None and width > self.oom_above):
            err: Exception | None = FakeResourceExhaustedError(
                f"RESOURCE_EXHAUSTED: out of memory allocating a {width}-wide dispatch (injected)"
            )
        elif index in self.raise_at or (self.raise_when is not None and self.raise_when(host)):
            err = self.error_factory(index)
        else:
            err = None
        hang = index in self.hang_at

        def strike() -> None:
            if err is not None:
                raise err
            if hang:
                time.sleep(self.hang_s)

        return strike


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


# ---------------------------------------------------- suggestion-service chaos


# Deliberately a hand-written literal (not an import of ``SHED_POLICIES``):
# the tests hold the two equal (and to the reference's), so a shed rung
# without an overload scenario that forces it fails them, because an
# untested rung drops asks under exactly the load that makes the drop
# hardest to debug.
SHED_CHAOS_POLICIES: dict[str, str] = {
    "stale_queue": "invalidate the ready queue, then overload past the degrade depth; the "
    "stale proposals are served and counted, and the trials still complete",
    "independent": "overload past the independent depth with an empty queue; clients get "
    "empty relative proposals and converge via local independent sampling",
    "reject": "overload past the reject depth; the response carries RESOURCE_EXHAUSTED + "
    "retry-after, clients back off and converge, every shed is counted",
}


@dataclass(frozen=True)
class ServiceChaosPlan:
    """One deterministic suggestion-service chaos scenario: slow-tell thin
    clients, a poison server-resident sampler (raise + NaN proposals via
    :class:`FaultySampler` under ``GuardedSampler``), and a forced overload
    burst — all against ONE study — plus the exact outcome the acceptance
    test asserts (``tests/test_torch_serve_chaos.py``): server-side degrades
    carry ``sampler_fallback:`` attrs visible to clients, every shed is
    counted per rung exactly, shed responses carry retry-after and clients
    converge, zero trials stay RUNNING after drain, and the fault-free twin
    (ask-ahead off, width-1 asks) is bit-identical to a local-sampler study
    on the same seed.

    The burst is made deterministic by forcing the policy, not by racing
    threads: ``burst_asks`` sequential asks run under a ``reject_depth=0``
    policy (every ask sheds exactly once; clients are configured with zero
    shed retries so counters equal the plan), then the policy is restored
    and the same clients converge.
    """

    n_clients: int = 4
    n_trials: int = 24
    n_startup_trials: int = 4
    seed: int = 7
    slow_tell_s: float = 0.01
    # FaultySampler schedule over the server-resident sampler's relative
    # suggests: one raise + two NaN proposals — each degrades server-side.
    sampler_raise_at: tuple[int, ...] = (1,)
    sampler_nan_at: tuple[int, ...] = (2, 3)
    burst_asks: int = 5
    stale_burst_asks: int = 2
    independent_burst_asks: int = 3

    @property
    def expected_sheds(self) -> dict[str, int]:
        return {
            "reject": self.burst_asks,
            "stale_queue": self.stale_burst_asks,
            "independent": self.independent_burst_asks,
        }

    @property
    def expected_fallbacks(self) -> int:
        return len(self.sampler_raise_at) + len(self.sampler_nan_at)


def service_chaos_plan() -> ServiceChaosPlan:
    """The default :class:`ServiceChaosPlan` the chaos suite runs — four
    slow-tell clients, three server-side sampler faults, a five-ask reject
    burst plus forced stale/independent rungs."""
    return ServiceChaosPlan()


# ------------------------------------------------------------ hub-fleet chaos


# Chaos matrix for the hub fleet's routing events: every fault-tolerance
# decision the fleet layer can take (``storages/_grpc/fleet.py::
# FLEET_EVENTS``) maps to the hub-fault scenario ``tests/test_torch_serve_chaos.py``
# must prove forces it. Deliberately a hand-written literal (not an import of
# ``fleet.FLEET_EVENTS``): the tests hold the two equal, so a failover
# event without a hub-kill scenario that forces it fails them, because an
# unexercised failover path loses its first real in-flight ask during
# exactly the hub death it was built for.
HUB_CHAOS_MATRIX: dict[str, str] = {
    "hub_dead": "SIGKILL one of four hubs mid-burst (FakeHubFleet.kill leaves the stale "
    "-serve snapshot a real SIGKILL would); peers declare it dead exactly once and the "
    "doctor reports service.hub_dead naming the hub",
    "hub_rehome": "after the kill, asks for the dead hub's studies land on the ring "
    "successor, which adopts the published epoch watermark and rebuilds serve state from "
    "the shared journal",
    "ask_forward": "mis-route an ask at a non-owner hub; it is forwarded to the owner and "
    "answered (never rejected), with the cross-hub flow arrow recorded at both ends",
    "ask_replayed": "drop the response of a committed ask (committed-but-unacked), the "
    "client redials the next replica with the same op token; the successor replays the "
    "shared record — the trial's params are written exactly once",
    "shed_forward": "overload one hub into its reject rung while a peer idles; the ask is "
    "forwarded to the least-burning peer and answered before any client sees "
    "RESOURCE_EXHAUSTED; a fleet-wide burst still walks the client shed ladder",
}


@dataclass(frozen=True)
class HubChaosPlan:
    """One deterministic hub-fleet chaos scenario: ``n_hubs`` in-process
    fleet members (:class:`FakeHubFleet`) over ONE shared storage, a
    client burst, and a SIGKILL of one hub mid-burst — plus the exact
    outcome the acceptance test asserts (``tests/test_torch_serve_chaos.py``):
    zero lost asks (every client ask is answered), every in-flight ask of
    the dead hub is answered exactly once by a successor (op-token +
    shared replay record dedupe across the failover — the
    committed-but-unacked drops in ``drop_responses`` are the hard case),
    every healthy trial completes exactly once with zero RUNNING after the
    drain, the doctor reports ``service.hub_dead`` naming exactly the
    killed hub, and the fault-free fleet-of-1 twin is bit-identical to the
    single-hub service on the same seed.
    """

    n_hubs: int = 4
    n_clients: int = 4
    n_trials: int = 24
    n_startup_trials: int = 4
    seed: int = 7
    #: Trial count (per study) already served when the kill strikes — the
    #: burst is mid-flight, not cold or drained.
    kill_after_trials: int = 6
    #: Committed-but-unacked asks: the hub answers (and replicates) the ask,
    #: then the transport "dies" before the response reaches the client.
    #: The client's redial with the same token must hit the replay record.
    drop_responses: int = 2

    @property
    def killed_hub_index(self) -> int:
        """The hub to kill: index 0 of the fleet's hub list (the name is
        the fleet's choice; killing by index keeps the plan fleet-agnostic)."""
        return 0


def hub_chaos_plan() -> HubChaosPlan:
    """The default :class:`HubChaosPlan` the chaos suite runs — kill one of
    four hubs after six trials, with two committed-but-unacked drops."""
    return HubChaosPlan()


# Chaos matrix for the lease/fence layer's ownership transitions: every
# lease event the fencing layer can record (``storages/_grpc/fleet.py::
# LEASE_EVENTS``) maps to the gray-failure scenario
# ``tests/test_torch_serve_chaos.py`` must prove forces it. Deliberately a
# hand-written literal (not an import of ``fleet.LEASE_EVENTS``): the tests
# hold the two equal, so a lease transition without a partition scenario
# that forces it fails them, because an unexercised fence admits its first
# double-applied zombie write during exactly the partition it was built for.
LEASE_CHAOS_MATRIX: dict[str, str] = {
    "acquire": "serve the first ask of a fresh study on its ring-preferred hub; the "
    "lease:study: record lands with epoch 1 and that hub as owner, and the fault-free "
    "solo twin writes no lease attrs at all",
    "renew": "keep serving past the renewal cadence (ttl/2, injectable clock); the owner "
    "re-asserts the record in place — same epoch, refreshed renewed_unix, no history entry",
    "takeover": "partition the owning hub mid-burst (FakeHubFleet.kill); the ring "
    "successor re-homes, bumps the epoch, and on heal the returning primary bumps it "
    "again to reclaim (failback) — both transitions land in the bounded lease history",
    "demote": "let the partitioned owner keep serving behind the partition; its first "
    "fenced write (or renewal check) reveals the successor's higher epoch and it stops "
    "answering locally, draining parked asks with a redial-to-successor verdict",
    "fenced_write": "drive tells through the zombie so its checkpoint/replay/watermark "
    "writes carry the stale epoch; the fence rejects every one with StaleLeaseError and "
    "fleet.fenced_write counts them exactly — zero reach the shared journal",
}


@dataclass(frozen=True)
class LeaseChaosPlan:
    """One deterministic lease-fencing chaos scenario: a fleet over ONE
    shared journal storage, a client burst, an asymmetric partition of the
    owning hub mid-burst (killed for RPCs, alive in-process — the zombie),
    tells pushed through the zombie's still-mounted storage, then a heal
    and failback — plus the exact outcome the acceptance test asserts
    (``tests/test_torch_serve_chaos.py``): every zombie serve-state write is
    fenced and counted (``fleet.fenced_write`` equals the rejection count
    exactly), zero double-applied tells, zero lost parked asks (drained
    with redial verdicts, never aborted), the healed primary reclaims the
    lease with a fresh epoch, and the best value is bit-identical to the
    fault-free twin — all under the armed lock sanitizer.

    ``lease_check_ttl_s`` is 0 so every fence check reads through to
    storage: the test is deterministic, not cache-timing dependent.
    """

    n_hubs: int = 2
    n_trials: int = 16
    seed: int = 13
    #: Trials served before the partition strikes — mid-burst by design.
    partition_after_trials: int = 5
    #: Tells pushed through the zombie while partitioned; each drives a
    #: checkpoint write (checkpoint_every=1) the fence must reject.
    zombie_tells: int = 3
    lease_check_ttl_s: float = 0.0


def lease_chaos_plan() -> LeaseChaosPlan:
    """The default :class:`LeaseChaosPlan` the chaos suite runs — a
    two-hub fleet, partition after five trials, three zombie tells."""
    return LeaseChaosPlan()


# -------------------------------------------------------- preemption chaos


#: The preemption scenario for every checkpoint event
#: (``checkpoint.CHECKPOINT_EVENTS``): the loops' six and the serve tier's
#: hub re-home (``warm_load``).
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
    "warm_load": "kill a FakeHubFleet hub after its sampler fitted; the ring successor's "
    "adopt warm-loads the dead hub's exported sampler state and answers the next ask "
    "without a cold fit",
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


def mount_dispatch(
    storage: BaseStorage,
    service: Any = None,
    *,
    before: Callable[[str], None] | None = None,
    after: Callable[[str], None] | None = None,
) -> tuple[BaseStorage, Callable[..., Any]]:
    """Mount ``storage`` (wrapped by the suggestion ``service`` when one is
    given: a ``SuggestService`` or a ``FleetHub``) behind the server's
    grpc-free request dispatcher (``server._make_dispatch``: wire codec, op
    tokens, storage or service dispatch), with no socket. Returns ``(mounted
    storage, rpc(method, *args, **kwargs))``; an error answer raises its
    decoded exception. ``before(method)`` runs before the request is
    dispatched, ``after(method)`` once it was answered and before the answer
    is decoded (:class:`FakeHubFleet`'s kill and dropped response)."""
    from optuna_tpu_torch.storages._grpc import _service as wire
    from optuna_tpu_torch.storages._grpc.server import _make_dispatch

    mounted = service.wrap_storage(storage) if service is not None else storage
    dispatch = _make_dispatch(mounted, service)

    def rpc(method: str, *args: Any, **kwargs: Any) -> Any:
        if before is not None:
            before(method)
        response = dispatch(wire.encode_request(method, args, kwargs))
        if after is not None:
            after(method)
        ok, payload = wire.decode_response(response)
        if not ok:
            raise payload
        return payload

    return mounted, rpc


def thin_client_ask(rpc: Callable[..., Any]) -> Callable[[int, int, int, str], dict]:
    """A ``ThinClientSampler`` ask callable over ``rpc`` (a
    :func:`mount_dispatch` rpc): the op token rides the wire as a thin
    client's gRPC ask sends it."""
    from optuna_tpu_torch.storages._grpc._service import OP_TOKEN_KEY

    def ask(study_id: int, trial_id: int, number: int, token: str) -> dict:
        return rpc("service_ask", study_id, trial_id, number, **{OP_TOKEN_KEY: token})

    return ask


class FakeHubFleet:
    """N in-process fleet hubs over ONE shared storage, without sockets:
    each hub is a real ``SuggestService`` wrapped in a real
    :class:`~optuna_tpu_torch.storages._grpc.fleet.FleetHub`, mounted behind the
    server's request dispatcher (``server._make_dispatch`` — op-token dedup,
    wire encode/decode, suggest dispatch all live; the reference mounts the
    gRPC handler around the same body, which needs ``grpc``), with hub-to-hub
    peer calls routed back through the same dispatchers so a kill severs
    forwarding too. Nothing here imports ``grpc``.

    Chaos controls:

    * :meth:`kill` — SIGKILL stand-in: every subsequent RPC to the hub
      raises :class:`~optuna_tpu_torch.storages._grpc.fleet.HubUnavailableError`,
      and the hub's ``<name>-serve`` health snapshots are rewritten
      ``age_s`` into the past (exactly the stale residue a real SIGKILL
      leaves — the process stops refreshing; nothing cleans up).
    * :meth:`heal` — the partition heals: RPCs flow again and a fresh
      snapshot is republished (the hub was alive behind the partition).
    * :meth:`drop_response` — committed-but-unacked: the hub executes the
      next ``count`` calls of ``method`` normally (writes commit, the
      replay record lands) but the response is dropped on the floor and
      the caller sees ``HubUnavailableError`` — the redial-with-same-token
      dedupe path's hard case.

    ``clock`` (monotonic: liveness and lease-renewal cadences) and ``now``
    (unix: lease expiry, snapshot ages) reach every hub, so a test moves
    the fleet's time instead of sleeping.

    ``client_asks()`` hands a :class:`fleet.FleetClient` the per-hub ask
    closures (op token + ``fleet_redial`` riding the wire exactly as the
    thin client sends them); :meth:`thin_client` builds the full
    ``ThinClientSampler`` on top.
    """

    def __init__(
        self,
        storage: BaseStorage,
        hub_names: Sequence[str],
        service_factory: Callable[[str], Any],
        *,
        replicas: int = 64,
        liveness_ttl_s: float = 0.0,
        lease_ttl_s: float | None = None,
        lease_check_ttl_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        now: Callable[[], float] = time.time,
    ) -> None:
        from optuna_tpu_torch.storages._grpc import _service as wire
        from optuna_tpu_torch.storages._grpc import fleet as fleet_mod

        self._wire = wire
        self._fleet_mod = fleet_mod
        self.storage = storage
        self.router = fleet_mod.FleetRouter(hub_names, replicas=replicas)
        self.hubs: dict[str, Any] = {}
        self.mounted: dict[str, BaseStorage] = {}
        self._rpc: dict[str, Callable[..., Any]] = {}
        self._killed: set[str] = set()
        self._drops: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self._now = now
        if lease_ttl_s is None:
            lease_ttl_s = fleet_mod.DEFAULT_LEASE_TTL_S
        for name in hub_names:
            service = service_factory(name)
            hub = fleet_mod.FleetHub(
                name,
                service,
                self.router,
                storage,
                liveness_ttl_s=liveness_ttl_s,
                lease_ttl_s=lease_ttl_s,
                lease_check_ttl_s=lease_check_ttl_s,
                clock=clock,
                now=now,
            )
            mounted, rpc = mount_dispatch(
                storage,
                hub,
                before=lambda _method, _name=name: self._check_alive(_name),
                after=lambda method, _name=name: self._maybe_drop(_name, method),
            )
            self.hubs[name] = hub
            self.mounted[name] = mounted
            self._rpc[name] = rpc
        for name, hub in self.hubs.items():
            for peer_name in hub_names:
                if peer_name != name:
                    hub.set_peer(peer_name, _FleetPeerStub(self, peer_name))

    # ------------------------------------------------------------- chaos taps

    def _check_alive(self, name: str) -> None:
        with self._lock:
            killed = name in self._killed
        if killed:
            from optuna_tpu_torch.storages._grpc.fleet import HubUnavailableError

            raise HubUnavailableError(f"fleet hub {name!r} is dead (injected kill).")

    def _maybe_drop(self, name: str, method: str) -> None:
        with self._lock:
            left = self._drops.get((name, method), 0)
            if left <= 0:
                return
            self._drops[(name, method)] = left - 1
        from optuna_tpu_torch.storages._grpc.fleet import HubUnavailableError

        raise HubUnavailableError(
            f"response from hub {name!r} dropped (committed-but-unacked {method})."
        )

    def kill(self, name: str, *, age_s: float = 3600.0) -> None:
        """SIGKILL stand-in: sever the hub's RPCs and leave its ``-serve``
        snapshots ``age_s`` stale (a dead process stops refreshing; the
        stale record IS the death signal the liveness check reads)."""
        from optuna_tpu_torch import health

        with self._lock:
            self._killed.add(name)
        worker_id = name + health.HUB_WORKER_ID_SUFFIX
        attr_key = health.WORKER_ATTR_PREFIX + worker_id
        for frozen in self.storage.get_all_studies():
            study_id = frozen._study_id
            snap = dict(
                health.worker_snapshots(self.storage, study_id).get(worker_id)
                or {"worker": worker_id, "pid": 0, "seq": 1, "counters": {},
                    "gauges": {}, "histograms": {}, "jit": {},
                    "interval_s": health.DEFAULT_INTERVAL_S}
            )
            snap["last_seen_unix"] = self._now() - age_s
            snap.pop("final", None)
            self.storage.set_study_system_attr(study_id, attr_key, snap)
        self.invalidate_liveness()

    def heal(self, name: str) -> None:
        """The partition heals: RPCs to the hub flow again and a fresh
        snapshot is republished for every study (the hub was alive the
        whole time — only unreachable)."""
        from optuna_tpu_torch import health

        with self._lock:
            self._killed.discard(name)
        worker_id = name + health.HUB_WORKER_ID_SUFFIX
        attr_key = health.WORKER_ATTR_PREFIX + worker_id
        for frozen in self.storage.get_all_studies():
            study_id = frozen._study_id
            snap = health.worker_snapshots(self.storage, study_id).get(worker_id)
            if snap is None:
                continue
            snap = dict(snap)
            snap["last_seen_unix"] = self._now()
            self.storage.set_study_system_attr(study_id, attr_key, snap)
        self.invalidate_liveness()

    def drop_response(self, name: str, method: str = "service_ask", count: int = 1) -> None:
        """Schedule the next ``count`` successful ``method`` calls on hub
        ``name`` to commit server-side but lose their response."""
        with self._lock:
            self._drops[(name, method)] = self._drops.get((name, method), 0) + count

    def invalidate_liveness(self) -> None:
        for hub in self.hubs.values():
            hub.invalidate_liveness()

    # --------------------------------------------------------------- clients

    def rpc(self, name: str, method: str, *args: Any, **kwargs: Any) -> Any:
        return self._rpc[name](method, *args, **kwargs)

    def client_asks(self) -> dict[str, Callable[..., dict]]:
        """Per-hub ask closures for :class:`fleet.FleetClient`: op token and
        ``fleet_redial`` ride the wire exactly as a thin client sends them."""
        wire = self._wire

        def make(name):
            def ask(study_id, trial_id, number, token, redial):
                return self.rpc(
                    name, "service_ask", study_id, trial_id, number,
                    fleet_redial=redial, **{wire.OP_TOKEN_KEY: token},
                )

            return ask

        return {name: make(name) for name in self.router.hubs}

    def fleet_client(self, **kwargs: Any) -> Any:
        """A :class:`fleet.FleetClient` over this fleet's handlers. Default
        backoff sleeps are suppressed (tests must not wait out real jitter)."""
        policy = kwargs.pop("retry_policy", None)
        if policy is None:
            from optuna_tpu_torch.storages._retry import RetryPolicy

            policy = RetryPolicy(
                max_attempts=2 * len(self.router.hubs) + 1, sleep=lambda _s: None
            )
        return self._fleet_mod.FleetClient(
            self.router, self.client_asks(), retry_policy=policy, **kwargs
        )

    def thin_client(self, **kwargs: Any) -> Any:
        """A ``ThinClientSampler`` whose asks walk the fleet (routing,
        redial, replay) instead of a single hub."""
        from optuna_tpu_torch.storages._grpc.suggest_service import ThinClientSampler

        return ThinClientSampler(self.fleet_client().ask, **kwargs)

    def close(self) -> None:
        for hub in self.hubs.values():
            try:
                hub.close()
            except Exception:  # teardown best-effort: one hub's close must not strand the rest
                pass


class _FleetPeerStub:
    """Peer protocol routed back through the fleet's own handlers: a
    forwarded ask crosses the same wire/op-token path a socket peer would,
    and a killed hub severs forwarding exactly like a dead socket."""

    def __init__(self, fleet: FakeHubFleet, name: str) -> None:
        self._fleet = fleet
        self.name = name

    def service_forwarded_ask(self, *args: Any, **kwargs: Any) -> dict:
        return self._fleet.rpc(self.name, "service_forwarded_ask", *args, **kwargs)

    def service_burn_verdict(self) -> dict:
        return self._fleet.rpc(self.name, "service_burn_verdict")


class SocketHubFleet(FakeHubFleet):
    """:class:`FakeHubFleet`'s real-socket twin: the same N fleet hubs over
    ONE shared storage, but each hub listens on its own loopback gRPC
    server and every client and peer RPC crosses a real channel — wire
    codec, HTTP/2 framing, kernel TCP, and server thread-pool dispatch all
    paid for. ``mounted[name]`` is a
    :class:`~optuna_tpu_torch.storages._grpc.client.GrpcStorageProxy`, so study
    create/load/tell traffic rides the wire too, exactly like a remote
    worker's.

    The chaos taps (:meth:`kill` / :meth:`heal` / :meth:`drop_response`)
    sever the CLIENT side of the channel, which is what a network partition
    does: the server keeps running behind the cut and its lease keeps
    aging — the gray-failure geometry the lease fencing exists for.

    Used by netchaos tests that want faults on a real channel rather than
    the handler-direct seam, and wherever the serve numbers need the real
    channel's latency."""

    def __init__(
        self,
        storage: BaseStorage,
        hub_names: Sequence[str],
        service_factory: Callable[[str], Any],
        *,
        replicas: int = 64,
        liveness_ttl_s: float = 0.0,
        lease_ttl_s: float | None = None,
        lease_check_ttl_s: float = 1.0,
        host: str = "localhost",
    ) -> None:
        import grpc

        from optuna_tpu_torch.storages._grpc import _service as wire
        from optuna_tpu_torch.storages._grpc import fleet as fleet_mod
        from optuna_tpu_torch.storages._grpc.client import GrpcStorageProxy
        from optuna_tpu_torch.storages._grpc.server import make_grpc_server
        from optuna_tpu_torch.testing.storages import _find_free_port

        self._wire = wire
        self._fleet_mod = fleet_mod
        self.storage = storage
        self.router = fleet_mod.FleetRouter(hub_names, replicas=replicas)
        self.hubs: dict[str, Any] = {}
        self.mounted: dict[str, BaseStorage] = {}
        self._rpc: dict[str, Callable[..., Any]] = {}
        self._killed: set[str] = set()
        self._drops: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self._now = time.time
        self._servers: list[Any] = []
        self._channels: dict[str, Any] = {}
        self._proxies: list[Any] = []
        self.ports: dict[str, int] = {}
        if lease_ttl_s is None:
            lease_ttl_s = fleet_mod.DEFAULT_LEASE_TTL_S
        for name in hub_names:
            service = service_factory(name)
            hub = fleet_mod.FleetHub(
                name,
                service,
                self.router,
                storage,
                liveness_ttl_s=liveness_ttl_s,
                lease_ttl_s=lease_ttl_s,
                lease_check_ttl_s=lease_check_ttl_s,
            )
            port = _find_free_port()
            # make_grpc_server mounts the hub's tell observer over the raw
            # storage itself — passing a pre-wrapped mount would observe
            # every tell twice.
            server = make_grpc_server(storage, host, port, suggest_service=hub)
            server.start()
            channel = grpc.insecure_channel(f"{host}:{port}")
            proxy = GrpcStorageProxy(host=host, port=port)

            def rpc(method, *args, _ch=channel, _name=name, **kwargs):
                self._check_alive(_name)
                raw = _ch.unary_unary(f"/{wire.SERVICE_NAME}/{method}")(
                    wire.encode_request(method, args, kwargs), timeout=120.0
                )
                self._maybe_drop(_name, method)
                ok, payload = wire.decode_response(raw)
                if not ok:
                    raise payload
                return payload

            self.hubs[name] = hub
            self.mounted[name] = proxy
            self._rpc[name] = rpc
            self._servers.append(server)
            self._channels[name] = channel
            self._proxies.append(proxy)
            self.ports[name] = port
        for name, hub in self.hubs.items():
            for peer_name in hub_names:
                if peer_name != name:
                    hub.set_peer(peer_name, _FleetPeerStub(self, peer_name))

    def channel(self, name: str) -> Any:
        """The hub's client-side channel — the seam
        ``testing.netchaos.NetChaos.intercept`` wraps for socket chaos."""
        return self._channels[name]

    def close(self) -> None:
        super().close()
        for proxy in self._proxies:
            try:
                proxy.remove_session()
            except Exception:  # teardown best-effort: one proxy's close must not strand the rest
                pass
        for channel in self._channels.values():
            try:
                channel.close()
            except Exception:  # teardown best-effort: one channel's close must not strand the rest
                pass
        for server in self._servers:
            try:
                server.stop(0)
            except Exception:  # teardown best-effort: one server's stop must not strand the rest
                pass


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
