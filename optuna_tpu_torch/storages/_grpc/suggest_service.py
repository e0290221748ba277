"""Batched suggestion service: the gRPC hub serves ask itself (port of
``optuna_tpu/storages/_grpc/suggest_service.py``).

The storage proxy made thousands of workers share one backing store,
but every worker still runs its *own* sampler: one ask = ~25 proxied storage
reads plus one full GP/TPE fit + proposal, per client. Asynchronous BO
driving many thin distributed workers from one server-resident model is the
architecture of VA-guided async-BO autotuning (Dorier et al.,
arXiv:2210.00798), and amortizing the indivisible fused fit+propose dispatch
across concurrent askers is the batching lever AccelOpt pulls for
kernel-optimization throughput. This module turns the hub into that server.
Three mechanisms:

1. **Coalesced batched ask** (:class:`_AskCoalescer`) — concurrent
   ``service_ask`` RPCs within a small window (or up to ``max_coalesce``)
   fuse into ONE ``sample_relative_batch`` dispatch against the
   server-resident sampler (the GP sampler's chain program fantasizes the
   batch kriging-believer style; TPE draws joint candidates), so N askers
   cost ~one fit+propose instead of N. The
   window clock is injectable (the :class:`~optuna_tpu_torch.storages._retry.
   RetryPolicy` contract) so batching tests are deterministic, and a
   graceful drain flushes the open window before the server stops accepting.
2. **Speculative ask-ahead** (:class:`_ReadyQueue`) — after tells land, a
   background worker pre-computes ``ready_ahead`` proposals (fantasized on
   pending/assumed outcomes via the same batch hook) so a steady-state ask
   is a queue pop: no fit, no proposal, sub-millisecond server time.
   Refills trigger at a low-water mark (the swap computes while the queue
   still serves) and invalidation — an epoch bump every
   ``invalidate_after`` tells, enough evidence to move the posterior — is
   double-buffered: the previous batch stays servable for
   ``max_stale_epochs`` bumps while the replacement lands. Entries beyond
   that bound are what the shed ladder's first rung serves. The refill
   worker schedules by demand: ask-path requests pop ahead of tell-path
   speculation, which itself only runs for studies with ask evidence
   since their last fill (an asker-less study keeps its boundedly-stale
   fill instead of stealing the worker from live fleets).
3. **Load shedding** (:class:`ShedPolicy`) — fed by the server's own ask
   queue depth and (optionally) the study doctor's findings, overload
   degrades down an explicit ladder: serve-from-stale-ready-queue ->
   independent-path proposals -> reject with ``RESOURCE_EXHAUSTED`` + a
   retry-after hint. Every shed is counted (``serve.shed.<policy>``) and
   flight-recorded; the policy vocabulary (:data:`SHED_POLICIES`) equals
   the chaos matrix ``testing/fault_injection.py::SHED_CHAOS_POLICIES``
   and the reference's.

The server-resident sampler always runs under
:class:`~optuna_tpu_torch.samplers._resilience.GuardedSampler`: a poisoned fit
degrades server-side and the ``sampler_fallback:`` system attrs it records
round-trip to thin clients through the storage they already share. A
device fault (:func:`~optuna_tpu_torch.samplers._resilience.is_device_fault`:
the card, or a kernel's build or launch) is never degraded, at any layer
here: a coalesced dispatch answers it to its askers as an error, the refill
worker parks it and re-raises it on that study's next ask, and the thin
client re-raises it instead of sampling independently.

Client side, :class:`ThinClientSampler` is a
:class:`~optuna_tpu_torch.samplers._base.BaseSampler` whose relative path is ONE
``service_ask`` RPC (op-tokened: a transport retry replays the recorded
response, never mints a second proposal) and whose independent path stays
local — against a pre-service server it degrades permanently to local
independent sampling instead of failing every trial.

Observability: ``serve.ask`` / ``serve.coalesce`` / ``serve.ready_queue``
phases (one vocabulary with the telemetry spine and the flight recorder),
``serve.shed.<policy>`` / ``serve.ready_queue.<event>`` counters,
``serve.*`` gauges riding the health snapshots, and two doctor checks
(``service.backpressure``, ``service.ready_queue_starved``) over the fleet
channel.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

from optuna_tpu_torch import flight, locksan, telemetry
from optuna_tpu_torch import checkpoint as _ckpt
from optuna_tpu_torch.distributions import (
    BaseDistribution,
    distribution_to_json,
    json_to_distribution,
)
from optuna_tpu_torch.logging import get_logger, warn_once
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._resilience import (
    SAMPLER_FALLBACK_ATTR_PREFIX,
    GuardedSampler,
    is_device_fault,
)
from optuna_tpu_torch.storages._base import BaseStorage, _ForwardingStorage
from optuna_tpu_torch.storages._grpc._service import OP_TOKEN_KEY
from optuna_tpu_torch.storages._retry import RetryPolicy
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study
    from optuna_tpu_torch.trial._frozen import FrozenTrial

_logger = get_logger(__name__)

#: The accepted shed-ladder rungs and what each does under overload. The
#: tests hold this set against the chaos matrix in
#: ``testing/fault_injection.py`` and the reference's: a rung without a chaos
#: scenario fails them.
SHED_POLICIES: dict[str, str] = {
    "stale_queue": "degrade: serve a stale (posterior-moved) ready-queue proposal without a fit",
    "independent": "degrade: serve an empty relative proposal; the client samples independently",
    "reject": "backpressure: refuse the ask with RESOURCE_EXHAUSTED and a retry-after hint",
}

#: The wire status string a rejected ask carries (the JSON wire has no gRPC
#: status enum; clients and dashboards match on this name).
RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"

#: Monotonic service tokens for warn-once keys (the GuardedSampler pattern:
#: ``id(self)`` recycles after GC).
_service_seq = itertools.count()


def _bucket_width(n: int) -> int:
    """Next power of two >= n: the coalesce-dispatch width bucket."""
    width = 1
    while width < n:
        width <<= 1
    return width


# ------------------------------------------------------------- shed policy


def _default_slo_source() -> Sequence[str]:
    """The default :class:`ShedPolicy` SLO feed: the in-process SLO
    engine's burning spec ids (empty while the engine is off, so the
    default wiring costs nothing until an operator arms it)."""
    from optuna_tpu_torch import slo

    return slo.burning_slo_ids()


class ShedPolicy:
    """The load-shedding ladder: maps the server's instantaneous ask queue
    depth (and, optionally, the study doctor's verdict) to a
    :data:`SHED_POLICIES` rung, or ``None`` to serve normally.

    Depth thresholds are inclusive lower bounds on the number of asks
    simultaneously in the miss path (the current ask included):

    * ``depth >= reject_depth`` -> ``"reject"`` with ``retry_after_s``;
    * ``depth >= independent_depth`` -> ``"independent"``;
    * ``depth >= degrade_depth`` *and* a stale ready-queue proposal exists
      -> ``"stale_queue"`` (with nothing to serve, coalescing itself is the
      absorb mechanism and the ask proceeds normally);
    * otherwise serve.

    ``findings_source`` feeds the doctor in: a callable returning the check
    ids of the study's current CRITICAL findings (cached for
    ``findings_ttl_s`` so the hot path never waits on a storage scan). While
    any CRITICAL finding stands — a fallback storm, a dead worker — the
    thresholds HALVE: a fleet that is already drowning sheds earlier
    instead of piling asks onto a degrading sampler.

    ``slo_source`` is the same mechanism one rung earlier in time: a
    callable returning the ids of SLOs currently *burning* their error
    budget (default: the in-process SLO engine,
    :func:`optuna_tpu_torch.slo.burning_slo_ids` — empty while the engine is
    off). A burning SLO halves the thresholds exactly like a CRITICAL
    finding, so shedding engages while the system is merely violating its
    latency promise — *before* the fleet degrades far enough to mint a
    CRITICAL doctor finding. Pass ``slo_source=lambda: ()`` to sever the
    feed (a benchmark of the server, not of the policy, does).
    """

    def __init__(
        self,
        *,
        degrade_depth: int = 32,
        independent_depth: int = 64,
        reject_depth: int = 128,
        retry_after_s: float = 0.05,
        findings_source: Callable[[], Sequence[str]] | None = None,
        findings_ttl_s: float = 5.0,
        slo_source: Callable[[], Sequence[str]] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if not (0 <= degrade_depth <= independent_depth <= reject_depth):
            raise ValueError(
                "shed thresholds must satisfy 0 <= degrade_depth <= "
                f"independent_depth <= reject_depth; got {degrade_depth}, "
                f"{independent_depth}, {reject_depth}."
            )
        self.degrade_depth = degrade_depth
        self.independent_depth = independent_depth
        self.reject_depth = reject_depth
        self.retry_after_s = retry_after_s
        self._findings_source = findings_source
        self._findings_ttl_s = findings_ttl_s
        self._slo_source = slo_source if slo_source is not None else _default_slo_source
        self._clock = clock
        self._findings_cached_at: float | None = None
        self._findings_critical = False
        self._findings_refreshing = False
        self._lock = locksan.lock("suggest.shed")

    def _fleet_critical(self) -> bool:
        if self._findings_source is None:
            if self._slo_source is None:
                return False
            if self._slo_source is _default_slo_source:
                from optuna_tpu_torch import slo

                if not slo.enabled():
                    # The common default configuration (no doctor feed, SLO
                    # engine not armed) keeps its pre-SLO lock-free fast
                    # path: decide() runs on every miss-path ask under
                    # saturation, and taking the policy lock to learn the
                    # disabled engine has nothing to say would tax exactly
                    # the load being measured.
                    return False
        with self._lock:
            now = self._clock()
            expired = (
                self._findings_cached_at is None
                or now - self._findings_cached_at >= self._findings_ttl_s
            )
            if not expired or self._findings_refreshing:
                # Everyone but the one refresher reads the cached verdict —
                # decide() is on the path of every miss-path ask, and a
                # doctor feed can be a full storage scan; stalling the whole
                # shed ladder behind it under overload would be self-defeat.
                return self._findings_critical
            self._findings_refreshing = True
        critical = False
        if self._findings_source is not None:
            try:
                critical = bool(tuple(self._findings_source()))
            except Exception as err:  # the doctor feed is advisory: a storage blip while reading findings must not take the shed policy (or the ask path) down with it
                _logger.warning(
                    f"shed policy findings source raised {err!r}; "
                    "treating the fleet as healthy this round."
                )
        if not critical and self._slo_source is not None:
            try:
                # A burning SLO is the earlier signal: the system is already
                # violating its latency promise even though no fleet-level
                # CRITICAL finding has minted yet — shed on it first.
                critical = bool(tuple(self._slo_source()))
            except Exception as err:  # the SLO feed is advisory too: an engine error must not take the shed policy down with it
                _logger.warning(
                    f"shed policy SLO source raised {err!r}; "
                    "treating the objectives as met this round."
                )
        with self._lock:
            self._findings_critical = critical
            self._findings_cached_at = self._clock()
            self._findings_refreshing = False
        return critical

    def decide(self, depth: int, stale_available: int) -> str | None:
        """The rung for an ask arriving at ``depth`` (current ask included)
        with ``stale_available`` stale ready-queue proposals on hand."""
        scale = 0.5 if self._fleet_critical() else 1.0
        if depth >= max(1, int(self.reject_depth * scale)):
            return "reject"
        if depth >= max(1, int(self.independent_depth * scale)):
            return "independent"
        if depth >= max(1, int(self.degrade_depth * scale)) and stale_available > 0:
            return "stale_queue"
        return None


# --------------------------------------------------------------- coalescer


class _PendingAsk:
    """One asker parked in the coalescer, and its eventual proposal.
    ``flow`` is the flight-recorder flow id stitching this parked ask to
    the fused dispatch that serves it (the fan-in arrow); None while the
    recorder is off."""

    __slots__ = ("trial_id", "number", "done", "params", "dists", "fallback", "error", "flow")

    def __init__(self, trial_id: int, number: int) -> None:
        self.trial_id = trial_id
        self.number = number
        self.done = threading.Event()
        self.params: dict[str, Any] = {}
        self.dists: dict[str, str] = {}
        self.fallback: str | None = None
        self.error: BaseException | None = None
        self.flow: str | None = None


class _AskCoalescer:
    """Fuse concurrent asks into one proposal dispatch.

    The first asker of a round becomes the *leader*: it waits until the
    batch is full (``max_batch``), the window expires (``window_s`` on the
    injectable ``clock``), or a drain is requested — then takes up to
    ``max_batch`` pending asks and runs ONE dispatch for them (any overflow
    stays parked for the leader's next round, keeping dispatch widths
    inside the prewarmed ladder). Followers park on their item's event. The
    leader re-checks for late arrivals before abdicating, so no asker can
    be left parked without a leader.
    """

    def __init__(
        self,
        *,
        window_s: float = 0.004,
        max_batch: int = 16,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.window_s = window_s
        self.max_batch = max_batch
        self._clock = clock
        self._cond = locksan.condition("suggest.coalesce")
        self._pending: list[_PendingAsk] = []
        self._leader_active = False
        self._draining = False

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def drain(self) -> None:
        """Flush the open window now: the pending batch dispatches
        immediately instead of waiting out ``window_s`` (the SIGTERM path —
        parked askers are answered before the listener stops accepting)."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def submit(
        self, item: _PendingAsk, dispatch: Callable[[list[_PendingAsk]], None]
    ) -> _PendingAsk:
        """Park ``item`` for the next fused dispatch; returns it filled.
        ``dispatch`` must fill every item of its batch and never raise —
        per-item errors ride ``item.error``."""
        with self._cond:
            self._pending.append(item)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
            self._cond.notify_all()
        if lead:
            self._lead(dispatch)
        # Bounded park: the leader contract above means this only ever waits
        # for a dispatch already in flight; the timeout is a deadlock
        # backstop, not a control path.
        if not item.done.wait(timeout=300.0):
            item.error = RuntimeError(
                "coalesced ask timed out waiting for its batch dispatch"
            )
        return item

    def _lead(self, dispatch: Callable[[list[_PendingAsk]], None]) -> None:
        while True:
            batch = self._collect()
            if batch:
                try:
                    dispatch(batch)
                finally:
                    # Backstop on the dispatch contract: never leave a
                    # follower parked forever.
                    for item in batch:
                        item.done.set()
            with self._cond:
                if not self._pending:
                    self._leader_active = False
                    return

    def _collect(self) -> list[_PendingAsk]:
        deadline = self._clock() + self.window_s
        with self._cond:
            while (
                len(self._pending) < self.max_batch
                and not self._draining
                and self._pending
            ):
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                # Short real-time slices keep the injectable clock in
                # charge of the *logical* window while the condition still
                # wakes immediately on an append or a drain.
                self._cond.wait(timeout=min(remaining, 0.002))
            # Take at most max_batch: asks that piled up past the cap while
            # a dispatch was in flight stay parked for the leader's next
            # round, so a dispatch width never exceeds the power-of-two
            # ladder prewarm ran (an over-wide swap would pay a first call
            # at a new width on the hot path, under overload of all times).
            batch = self._pending[: self.max_batch]
            del self._pending[: self.max_batch]
            return batch


# -------------------------------------------------------------- ready queue


class _ReadyEntry:
    """``flow`` is the flight-recorder flow id minted by the refill (or
    coalesce-surplus) dispatch that produced this proposal: the queue pop
    that consumes it closes the fan-out arrow, so a served ask's provenance
    — which dispatch, which epoch — is one arrow in Perfetto."""

    __slots__ = ("params", "dists", "epoch", "flow")

    def __init__(
        self,
        params: dict[str, Any],
        dists: dict[str, str],
        epoch: int,
        flow: str | None = None,
    ) -> None:
        self.params = params
        self.dists = dists
        self.epoch = epoch
        self.flow = flow


class _ReadyQueue:
    """Per-study speculative proposal queue with epoch invalidation.

    Entries minted at epoch E age as ``invalidate()`` bumps the epoch.
    The normal serve path accepts entries at most ``max_behind`` epochs old
    (the service's ``max_stale_epochs``): with the default 1, the queue
    double-buffers — an invalidation keeps serving the previous batch,
    boundedly stale, while the refill swap is in flight, so steady-state
    asks never fall into a fit just because the posterior moved. Entries
    *beyond* the bound are what the shed ladder's first rung serves under
    overload; ``max_behind=0`` is the strict mode (any invalidation stales
    the whole queue immediately) the deterministic tests pin.
    """

    def __init__(self, maxlen: int) -> None:
        self._entries: deque[_ReadyEntry] = deque(maxlen=max(1, maxlen))
        self.epoch = 0
        self._lock = locksan.lock("suggest.ready_queue")

    def pop_fresh(self, max_behind: int = 0) -> _ReadyEntry | None:
        with self._lock:
            if self._entries and self.epoch - self._entries[0].epoch <= max_behind:
                return self._entries.popleft()
            return None

    def pop_any(self) -> _ReadyEntry | None:
        with self._lock:
            return self._entries.popleft() if self._entries else None

    def stale_len(self, max_behind: int = 0) -> int:
        with self._lock:
            if self._entries and self.epoch - self._entries[0].epoch > max_behind:
                return len(self._entries)
            return 0

    def fresh_len(self, max_behind: int = 0) -> int:
        with self._lock:
            if self._entries and self.epoch - self._entries[0].epoch <= max_behind:
                return len(self._entries)
            return 0

    def invalidate(self) -> None:
        with self._lock:
            self.epoch += 1

    def refill(self, entries: Sequence[_ReadyEntry]) -> None:
        with self._lock:
            self._entries.clear()
            self._entries.extend(entries)

    def push_fresh(self, entries: Sequence[_ReadyEntry]) -> None:
        """Append fresh-epoch entries (surplus proposals from a padded
        coalesce dispatch). Stale residue is dropped first so the queue
        stays epoch-homogeneous (``pop_fresh`` checks only the head)."""
        with self._lock:
            if self._entries and self._entries[0].epoch != self.epoch:
                self._entries.clear()
            self._entries.extend(entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ------------------------------------------------------------ study handles


class _StudyHandle:
    """Everything the service holds per served study: the server-side Study
    bound to the backing storage, its guarded server-resident sampler, the
    ready queue, its own ask coalescer (coalescing is per-study — two
    studies' concurrent asks must never fuse into one batch), and the
    tell/invalidations bookkeeping."""

    def __init__(
        self,
        study: "Study",
        guarded: GuardedSampler,
        queue: _ReadyQueue,
        coalescer: _AskCoalescer,
    ) -> None:
        self.study = study
        self.guarded = guarded
        self.queue = queue
        self.coalescer = coalescer
        self.tells_since_fill = 0
        #: Asks served since the last refill — the demand evidence that
        #: gates purely speculative (tell-path) refills. Unsynchronized
        #: increments are fine: this is a nonzero/zero heuristic, not a
        #: counter anything aggregates.
        self.asks_since_fill = 0
        #: Tells this handle has observed over its lifetime — the
        #: ``ckpt:hub`` watermark — and the ring's write counter (lazily
        #: seeded above any dead hub's seq at the first write).
        self.tells_total = 0
        self.ckpt_seq: int | None = None
        self.lock = locksan.lock("suggest.handle")


class _TellObserverStorage(_ForwardingStorage):
    """Transparent storage wrapper the server mounts instead of the raw
    backing storage: terminal ``set_trial_state_values`` writes — the tells
    of every client, thin or not — notify the suggestion service so it can
    invalidate and speculatively refill its ready queues. Pure observation:
    the write happened first, and an observer error never propagates into
    the client's tell."""

    def __init__(self, backend: BaseStorage, service: "SuggestService") -> None:
        super().__init__(backend)
        self._service = service

    def set_trial_state_values(
        self, trial_id: int, state: "TrialState", values: Sequence[float] | None = None
    ) -> bool:
        result = self._forward("set_trial_state_values", trial_id, state, values)
        if result and state.is_finished():
            try:
                self._service.note_tell(trial_id, state)
            except Exception as err:  # observation boundary: the tell is already committed; a speculation bookkeeping error must never surface as a storage failure to the telling client
                _logger.warning(f"suggest-service tell observer raised {err!r}.")
        return result


# ---------------------------------------------------------------- service


class SuggestService:
    """The server-side suggestion engine one gRPC hub mounts.

    ``sampler_factory`` builds one sampler per served study (server-resident
    state: kernel-param warm starts, device-space caches, RNG); every
    instance is wrapped in :class:`GuardedSampler` under ``fallback`` so a
    poisoned fit degrades per-ask instead of taking the service down.

    Knobs (all per-service): ``coalesce_window_s``/``max_coalesce`` bound
    the ask-fusing window, ``ready_ahead`` sizes the speculative queue
    (``0`` disables ask-ahead — the deterministic-parity configuration),
    ``invalidate_after`` is the tell count that moves the posterior enough
    to stale the queue, ``shed_policy`` is the overload ladder, and
    ``clock`` is the injectable time source shared by the window and the
    policy.
    """

    def __init__(
        self,
        storage: BaseStorage,
        sampler_factory: Callable[[], BaseSampler],
        *,
        fallback: str = "independent",
        coalesce_window_s: float = 0.004,
        max_coalesce: int = 16,
        ready_ahead: int = 8,
        invalidate_after: int = 4,
        max_stale_epochs: int = 1,
        shed_policy: ShedPolicy | None = None,
        clock: Callable[[], float] = time.monotonic,
        health_reporting: bool = True,
        health_worker_id: str | None = None,
        checkpoint_every: int = 8,
    ) -> None:
        self._storage = storage
        self._sampler_factory = sampler_factory
        self._fallback = fallback
        self.ready_ahead = int(ready_ahead)
        self.invalidate_after = max(1, int(invalidate_after))
        #: How many invalidation epochs behind a ready-queue proposal may be
        #: and still serve on the NORMAL path. The default 1 double-buffers:
        #: an epoch bump keeps serving the previous batch (boundedly stale —
        #: at most ~2x invalidate_after tells behind the posterior, the
        #: same bounded lag constant-liar fantasization accepts) while the
        #: refill swap is in flight. 0 is the strict mode: any invalidation
        #: stales the queue immediately and misses pay a real fit.
        self.max_stale_epochs = max(0, int(max_stale_epochs))
        #: Tell-tick cadence of the durable ``ckpt:hub`` fitted-state
        #: snapshot (0 disables): every N observed tells the handle's
        #: GuardedSampler exports its fit + ready-queue epoch into the
        #: study's checkpoint ring, so a re-homing successor hub warm-loads
        #: instead of paying a cold fit.
        self.checkpoint_every = max(0, int(checkpoint_every))
        self.shed_policy = shed_policy if shed_policy is not None else ShedPolicy(clock=clock)
        self._clock = clock
        self._health_reporting = health_reporting
        #: The worker id this hub's health snapshots publish under. A fleet
        #: member passes its hub name + the ``-serve`` suffix so hub
        #: liveness (and the ``service.hub_dead`` check) can tell N hubs in
        #: a fleet apart; the default keeps the single-hub id.
        self._health_worker_id = health_worker_id
        self.coalesce_window_s = coalesce_window_s
        self.max_coalesce = max(1, int(max_coalesce))
        self._handles: dict[int, _StudyHandle] = {}
        self._handles_lock = locksan.lock("suggest.handles")
        self._inflight = 0
        self._inflight_lock = locksan.lock("suggest.inflight")
        self._token = next(_service_seq)
        self._closed = False
        self._draining = False
        # One background speculation worker per service: refills are device
        # dispatches and must never run on (or block) an RPC handler thread.
        # Two queues: ``_refill_demand`` holds studies whose ASK path asked
        # for supply (live consumers), ``_refill_needed`` holds purely
        # speculative tell-path requests. Demand always pops first — a study
        # nobody is asking must never head-of-line-block a refill that a
        # live fleet is about to drain (its fit can be several times slower
        # at deeper history).
        self._refill_needed: set[int] = set()
        self._refill_demand: set[int] = set()
        self._refill_cond = locksan.condition("suggest.refill")
        self._refill_thread: threading.Thread | None = None
        #: study_id -> a device fault the refill worker hit for the study,
        #: re-raised on the study's next ask (never swallowed as a failed
        #: speculation: a card fault must surface where a caller waits).
        self._refill_faults: dict[int, BaseException] = {}
        # Register as an autopilot action target: the service.shed_earlier
        # remediation drives this hub's shed thresholds + ready-queue
        # prewarm (one weakref write; nothing runs while autopilot is off).
        from optuna_tpu_torch import autopilot

        autopilot.note_service(self)

    # ------------------------------------------------------------ plumbing

    def wrap_storage(self, storage: BaseStorage) -> BaseStorage:
        """The storage the gRPC server should actually mount: tells flow
        through and feed this service's speculation."""
        return _TellObserverStorage(storage, self)

    def _handle(self, study_id: int) -> _StudyHandle:
        with self._handles_lock:
            handle = self._handles.get(study_id)
            if handle is not None:
                return handle
        # Build outside the dict lock (storage reads); last writer wins the
        # benign race.
        from optuna_tpu_torch.study.study import Study

        name = self._storage.get_study_name_from_id(study_id)
        guarded = GuardedSampler(self._sampler_factory(), fallback=self._fallback)
        study = Study(name, self._storage, sampler=guarded)
        queue = _ReadyQueue(maxlen=max(1, 2 * max(1, self.ready_ahead)))
        coalescer = _AskCoalescer(
            window_s=self.coalesce_window_s,
            max_batch=self.max_coalesce,
            clock=self._clock,
        )
        if self._draining:
            coalescer.drain()
        handle = _StudyHandle(study, guarded, queue, coalescer)
        with self._handles_lock:
            existing = self._handles.setdefault(study_id, handle)
        if existing is handle and self._health_reporting:
            from optuna_tpu_torch import health

            # The service's containment + serve counters join the fleet
            # channel under a service-suffixed worker id, so the doctor's
            # backpressure/starvation checks can see them from anywhere.
            worker_id = self._health_worker_id
            if worker_id is None:
                worker_id = health.default_worker_id() + health.HUB_WORKER_ID_SUFFIX
            health.attach(study, worker_id=worker_id)
        if existing is handle:
            from optuna_tpu_torch import autopilot

            # The hub's own control loop (no-op unless opted in): the
            # service.* findings have their one actuator here, so the hub
            # attaches at handle creation the way optimize loops attach at
            # entry.
            autopilot.attach(study)
        return existing

    def _fresh_trials_view(self, handle: _StudyHandle) -> None:
        # The server never calls study.ask(), which is what normally resets
        # the per-thread history cache — clear it so every dispatch fits on
        # the tells that have actually landed.
        handle.study._thread_local.cached_all_trials = None

    def _frozen(self, trial_id: int) -> "FrozenTrial":
        return self._storage.get_trial(trial_id)

    @staticmethod
    def _encode_space(space: Mapping[str, BaseDistribution]) -> dict[str, str]:
        return {name: distribution_to_json(dist) for name, dist in space.items()}

    # ----------------------------------------------------------------- ask

    def service_ask(
        self,
        study_id: int,
        trial_id: int,
        trial_number: int,
        op_token: str | None = None,
        fleet_redial: bool = False,
    ) -> dict:
        """One thin-client ask: ready-queue pop, shed rung, or coalesced
        fused dispatch — in that order. Returns the wire response dict.

        ``op_token``/``fleet_redial`` are the fleet-replication hooks (the
        server re-injects the op token for suggest methods; a fleet client
        marks redialed attempts): a bare single hub ignores both — its
        in-process token cache already dedupes same-process retries, and
        there is no successor to replicate for.
        """
        with telemetry.span("serve.ask"), flight.span("serve.ask"):
            return self._ask_impl(study_id, trial_id, trial_number)

    def service_burn_verdict(self) -> dict:
        """This hub's SLO burn verdict + load level, for the fleet's
        shed-forward peer ranking (:mod:`optuna_tpu_torch.storages._grpc.fleet`).
        Cheap by construction — a handful of in-memory reads — because
        peers call it on every shed decision."""
        from optuna_tpu_torch import slo

        score = slo.burn_score()
        return {
            "depth": self._inflight,
            "score": 0.0 if score == float("inf") else score,
            "critical": score == float("inf"),
            "burning": score > 0.0,
            "draining": self._draining,
        }

    def _ask_impl(self, study_id: int, trial_id: int, trial_number: int) -> dict:
        with self._refill_cond:
            fault = self._refill_faults.pop(study_id, None)
        if fault is not None:
            raise fault
        handle = self._handle(study_id)
        handle.asks_since_fill += 1
        if self._health_reporting:
            from optuna_tpu_torch import health

            # Serving asks IS liveness: a hub whose clients tell through a
            # *different* storage endpoint never reaches note_tell, and
            # without a -serve snapshot its death is "unknown, not dead" to
            # the fleet — no re-home, no lease takeover. The reporter
            # rate-limits to its interval, so this is a clock read per ask.
            health.maybe_report(handle.study)
        self._publish_depth_gauges(study_id, handle)
        entry = handle.queue.pop_fresh(self.max_stale_epochs)
        if entry is not None:
            telemetry.count("serve.ready_queue.hit")
            if entry.flow is not None:
                # Fan-out provenance: close the arrow the minting refill
                # dispatch opened — "this ask was served by THAT dispatch,
                # minted at THAT epoch", one hop in Perfetto.
                flight.flow(
                    "serve.ready_queue.fanout", entry.flow, "in",
                    trial=trial_number, meta={"epoch": entry.epoch},
                )
            self._maybe_request_refill(study_id, handle, demand=True)
            return {
                "params": entry.params,
                "dists": entry.dists,
                "fallback": None,
                "shed": None,
                "source": "ready_queue",
            }
        telemetry.count("serve.ready_queue.miss")
        with self._inflight_lock:
            self._inflight += 1
            depth = self._inflight
        try:
            stale_available = handle.queue.stale_len(self.max_stale_epochs)
            rung = self.shed_policy.decide(depth, stale_available)
            if self._draining:
                # The flush answers what was already parked; a NEW ask during
                # wind-down is refused so the client re-dials the successor.
                rung = "reject"
            if rung == "reject":
                telemetry.count(
                    "serve.shed.reject",
                    meta={"rung": "reject", "depth": depth, "stale": stale_available},
                )
                return {
                    "params": {},
                    "dists": {},
                    "fallback": None,
                    "shed": "reject",
                    "status": RESOURCE_EXHAUSTED,
                    "retry_after_s": self.shed_policy.retry_after_s,
                    "source": "shed",
                }
            if rung == "stale_queue":
                stale = handle.queue.pop_any()
                if stale is not None:
                    telemetry.count(
                        "serve.shed.stale_queue",
                        meta={
                            "rung": "stale_queue",
                            "depth": depth,
                            "stale": stale_available,
                        },
                    )
                    if stale.flow is not None:
                        flight.flow(
                            "serve.ready_queue.fanout", stale.flow, "in",
                            trial=trial_number, meta={"epoch": stale.epoch},
                        )
                    self._maybe_request_refill(study_id, handle, demand=True)
                    return {
                        "params": stale.params,
                        "dists": stale.dists,
                        "fallback": None,
                        "shed": "stale_queue",
                        "source": "stale_queue",
                    }
                rung = "independent"
            if rung == "independent":
                telemetry.count(
                    "serve.shed.independent",
                    meta={
                        "rung": "independent",
                        "depth": depth,
                        "stale": stale_available,
                    },
                )
                return {
                    "params": {},
                    "dists": {},
                    "fallback": None,
                    "shed": "independent",
                    "source": "shed",
                }
            item = _PendingAsk(trial_id, trial_number)
            if flight.enabled():
                # Fan-in: open the arrow inside THIS ask's serve.ask span;
                # the leader's fused dispatch closes it — N parked asks, N
                # arrows converging on the one serve.coalesce slice.
                item.flow = flight.new_flow_id()
                flight.flow("serve.ask.fanin", item.flow, "out", trial=trial_number)
            handle.coalescer.submit(
                item, lambda batch: self._dispatch_batch(handle, batch)
            )
            if item.error is not None:
                raise item.error
            self._maybe_request_refill(study_id, handle, demand=True)
            return {
                "params": item.params,
                "dists": item.dists,
                "fallback": item.fallback,
                "shed": None,
                "source": "coalesced",
            }
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _dispatch_batch(self, handle: _StudyHandle, batch: list[_PendingAsk]) -> None:
        """ONE fused proposal dispatch for a coalesced batch. Fills every
        item; never raises (per-item errors ride ``item.error``)."""
        telemetry.set_gauge("serve.coalesce.width.last", len(batch))
        telemetry.max_gauge("serve.coalesce.width.max", len(batch))
        try:
            with telemetry.span("serve.coalesce"), flight.span("serve.coalesce"):
                for item in batch:
                    if item.flow is not None:
                        # Close every parked asker's fan-in arrow inside
                        # this dispatch's slice: "why was this ask slow"
                        # walks the arrow to the one dispatch that served
                        # the whole batch.
                        flight.flow(
                            "serve.ask.fanin", item.flow, "in",
                            trial=item.number, meta={"width": len(batch)},
                        )
                # handle.lock serializes this dispatch against the refill
                # worker (refill_now) and prewarm: all three drive the ONE
                # server-resident GuardedSampler, whose fit state, RNG, and
                # last_batch_fallback_reason are not safe under concurrent
                # sample_relative_batch calls (an interleaved refill would
                # reset the fallback reason this dispatch is about to read).
                with handle.lock:
                    self._propose_into(handle, batch)
        except Exception as err:  # dispatch containment: a failure here answers every parked asker with the error instead of stranding them; GuardedSampler already absorbed sampler-level faults upstream
            for item in batch:
                if item.error is None and not item.done.is_set():
                    item.error = err
        finally:
            for item in batch:
                item.done.set()

    def _propose_into(self, handle: _StudyHandle, batch: list[_PendingAsk]) -> None:
        study, guarded = handle.study, handle.guarded
        self._fresh_trials_view(handle)
        leader_frozen = self._frozen(batch[0].trial_id)
        space = guarded.infer_relative_search_space(study, leader_frozen)
        dists = self._encode_space(space)
        if not space:
            # Startup / no intersection: every client samples independently.
            for item in batch:
                item.params, item.dists = {}, {}
            return
        if len(batch) == 1:
            # Width-1 parity path: a lone ask runs the exact per-trial
            # ``sample_relative`` a local sampler would — same code, same
            # RNG consumption — so a sequential thin client is bit-identical
            # to the unbatched local-sampler study (the chaos suite's
            # fault-free twin). Joint/fantasized proposals are reserved for
            # genuinely concurrent batches.
            item = batch[0]
            item.params = dict(guarded.sample_relative(study, leader_frozen, space))
            item.dists = dists
            return
        # Power-of-two width bucketing: the batch hooks specialize on the
        # proposal count (shapes, caches), so free-running coalesce widths
        # would mint one first call per width. Padding to the next power of
        # two bounds the set to log2(max_coalesce) widths, and the surplus
        # proposals — distinct by construction (kriging-believer chain /
        # top-k) — seed the ready queue instead of being dropped.
        q = _bucket_width(len(batch))
        proposals = guarded.sample_relative_batch(study, space, q)
        if proposals is not None and len(proposals) >= len(batch):
            for item, params in zip(batch, proposals):
                item.params = dict(params)
                item.dists = dists
            surplus = proposals[len(batch):]
            if surplus and self.ready_ahead > 0 and not self._draining:
                epoch = handle.queue.epoch
                handle.queue.push_fresh(
                    [
                        _ReadyEntry(dict(p), dists, epoch, flow=self._mint_fanout(epoch))
                        for p in surplus
                    ]
                )
            return
        reason = guarded.last_batch_fallback_reason
        if reason is not None:
            # The server-resident sampler degraded: GuardedSampler recorded
            # the study-level attr + counter; mirror the reason onto each
            # served trial so thin clients see exactly the fallback attrs a
            # local GuardedSampler would have written.
            for item in batch:
                item.params, item.dists = {}, {}
                item.fallback = reason
                try:
                    # fallback path only, never the served hot path; the attr write must be ordered before the batch returns, and handle.lock is per-study so other studies keep serving
                    self._storage.set_trial_system_attr(
                        item.trial_id,
                        SAMPLER_FALLBACK_ATTR_PREFIX + "relative_batch",
                        reason,
                    )
                except Exception as attr_err:  # the attr is diagnostics; a storage blip on it must not turn a contained server-side fallback into a failed ask
                    _logger.warning(
                        f"recording served fallback attr raised {attr_err!r}."
                    )
            return
        # Batch hook declined (sampler without the hook, or startup by its
        # own accounting): per-trial relative sampling under the same guard.
        for item in batch:
            frozen = (
                leader_frozen
                if item.trial_id == batch[0].trial_id
                else self._frozen(item.trial_id)
            )
            params = guarded.sample_relative(study, frozen, space)
            item.params = dict(params)
            item.dists = dists

    @staticmethod
    def _mint_fanout(epoch: int) -> str | None:
        """Open a fan-out arrow for one minted proposal (inside the minting
        dispatch's span, on its thread — the enclosing-slice binding rule);
        None while the recorder is off."""
        if not flight.enabled():
            return None
        flow_id = flight.new_flow_id()
        flight.flow(
            "serve.ready_queue.fanout", flow_id, "out", meta={"epoch": epoch}
        )
        return flow_id

    #: Per-study gauge suffixes publish only while the service holds at
    #: most this many study handles: gauge names are never evicted from the
    #: registry (and ride every health snapshot), so a hub cycling through
    #: thousands of short-lived studies must not mint an unbounded series
    #: set. Past the cap, the un-suffixed gauges (most recently touched
    #: study) keep reporting levels; `state()` keeps the full breakdown.
    _PER_STUDY_GAUGE_CAP = 32

    def _publish_depth_gauges(self, study_id: int, handle: _StudyHandle) -> None:
        """Live backpressure levels as telemetry gauges (the ``state()``
        introspection surface, exported): inflight miss-path asks, coalesce
        window occupancy, ready-queue depth + epoch (per-study while the
        handle count stays under :data:`_PER_STUDY_GAUGE_CAP`). ``/metrics``
        then shows *levels*, not just shed counters — an operator sees the
        queue draining before the first shed fires. One enabled check, a
        few lock-guarded reads; nothing while telemetry is off."""
        if not telemetry.enabled():
            return
        telemetry.set_gauge("serve.inflight.last", self._inflight)
        telemetry.set_gauge("serve.coalesce.depth.last", handle.coalescer.depth)
        depth, epoch = len(handle.queue), handle.queue.epoch
        telemetry.set_gauge("serve.ready_queue.depth.last", depth)
        telemetry.set_gauge("serve.ready_queue.epoch.last", epoch)
        if len(self._handles) <= self._PER_STUDY_GAUGE_CAP:
            telemetry.set_gauge(f"serve.ready_queue.depth.s{study_id}.last", depth)
            telemetry.set_gauge(f"serve.ready_queue.epoch.s{study_id}.last", epoch)

    # ----------------------------------------------------------- ask-ahead

    def _maybe_request_refill(
        self, study_id: int, handle: _StudyHandle, demand: bool = False
    ) -> None:
        if self.ready_ahead <= 0 or self._closed or self._draining:
            return
        # Low-water refill on the strictly-current supply: the swap is
        # computed while the queue still serves (the previous epoch's batch
        # counts as servable but not as supply), so steady-state consumers
        # never hit an empty queue just because a refill is in flight.
        if handle.queue.fresh_len(0) >= max(1, self.ready_ahead // 2):
            return
        with self._refill_cond:
            (self._refill_demand if demand else self._refill_needed).add(study_id)
            if self._refill_thread is None:
                self._refill_thread = threading.Thread(
                    target=self._refill_loop,
                    name="optuna-tpu-suggest-refill",
                    daemon=True,
                )
                self._refill_thread.start()
            self._refill_cond.notify_all()

    def _refill_loop(self) -> None:
        while True:
            with self._refill_cond:
                while (
                    not self._refill_needed
                    and not self._refill_demand
                    and not self._closed
                ):
                    self._refill_cond.wait(timeout=1.0)
                if self._closed:
                    return
                if self._refill_demand:
                    study_id = self._refill_demand.pop()
                else:
                    study_id = self._refill_needed.pop()
                # One refill satisfies both kinds of request for the study.
                self._refill_demand.discard(study_id)
                self._refill_needed.discard(study_id)
            try:
                self.refill_now(study_id)
            except Exception as err:  # speculation is best-effort: a refill failure leaves the queue empty (asks coalesce instead) and must never kill the worker thread
                if is_device_fault(err):
                    with self._refill_cond:
                        self._refill_faults[study_id] = err
                    _logger.error(
                        f"ready-queue refill for study {study_id} hit a device "
                        f"fault {err!r}; the study's next ask raises it."
                    )
                    continue
                _logger.warning(f"ready-queue refill for study {study_id} raised {err!r}.")

    def refill_now(self, study_id: int) -> int:
        """Synchronously compute a fresh ready queue for ``study_id`` (the
        background worker's body; tests and a benchmark's warm-up call it
        directly). Returns the number of proposals enqueued."""
        handle = self._handle(study_id)
        with handle.lock:
            if self.ready_ahead <= 0:
                return 0
            with telemetry.span("serve.ready_queue"), flight.span("serve.ready_queue"):
                self._fresh_trials_view(handle)
                study, guarded = handle.study, handle.guarded
                trials = study._get_trials(deepcopy=False, use_cache=False)
                probe = trials[-1] if trials else None
                if probe is None:
                    return 0
                space = guarded.infer_relative_search_space(study, probe)
                if not space:
                    return 0
                proposals = guarded.sample_relative_batch(
                    study, space, self.ready_ahead
                )
                if not proposals:
                    return 0
                dists = self._encode_space(space)
                epoch = handle.queue.epoch
                handle.queue.refill(
                    [
                        _ReadyEntry(dict(params), dists, epoch, flow=self._mint_fanout(epoch))
                        for params in proposals
                    ]
                )
                handle.tells_since_fill = 0
                handle.asks_since_fill = 0
            telemetry.count("serve.ready_queue.refill")
            telemetry.set_gauge("serve.ready_queue.depth.last", len(handle.queue))
            self._publish_depth_gauges(study_id, handle)
            return len(handle.queue)

    def prewarm(self, study_id: int) -> int:
        """Pre-warm the coalesce width ladder for a study: run the batch
        hook once at every power-of-two width up to ``max_coalesce`` (the
        only widths dispatches ever use, thanks to the bucketing) plus the
        ready-ahead width, so the first real burst at any width pays no
        first-call cost. Proposals are discarded (a final refill seeds the queue);
        no trials are consumed. Returns the number of widths warmed —
        0 while the study is still in its startup phase."""
        handle = self._handle(study_id)
        with handle.lock:
            self._fresh_trials_view(handle)
            study, guarded = handle.study, handle.guarded
            trials = study._get_trials(deepcopy=False, use_cache=False)
            if not trials:
                return 0
            space = guarded.infer_relative_search_space(study, trials[-1])
            if not space:
                return 0
            widths = []
            width = 1
            while width <= self.max_coalesce:
                widths.append(width)
                width <<= 1
            if self.ready_ahead > 0 and self.ready_ahead not in widths:
                widths.append(self.ready_ahead)
            warmed = 0
            for width in widths:
                if width == 1:
                    guarded.sample_relative(study, trials[-1], space)
                    warmed += 1
                elif guarded.sample_relative_batch(study, space, width) is not None:
                    warmed += 1
        if self.ready_ahead > 0:
            self.refill_now(study_id)
        return warmed

    def note_tell(self, trial_id: int, state: "TrialState") -> None:
        """Tell observation hook (the server's storage wrapper calls this
        after every committed terminal state write): counts evidence toward
        queue invalidation and schedules a speculative refill."""
        with self._handles_lock:
            handles = list(self._handles.items())
        for study_id, handle in handles:
            # One storage serves few studies; probing each handle's study
            # for ownership would cost a read per tell — invalidation is
            # per-service evidence instead, conservative by design.
            handle.tells_since_fill += 1
            handle.tells_total += 1
            if (
                self.checkpoint_every > 0
                and handle.tells_total % self.checkpoint_every == 0
            ):
                self._write_hub_checkpoint(study_id, handle)
            if handle.tells_since_fill >= self.invalidate_after:
                if handle.queue.fresh_len() > 0:
                    telemetry.count("serve.ready_queue.invalidate")
                handle.queue.invalidate()
                handle.tells_since_fill = 0
            if handle.asks_since_fill > 0:
                # Speculate only where there is demand evidence: a study
                # nobody has asked since its last fill still holds that
                # fill (boundedly stale at worst), and re-minting it would
                # steal the one refill thread from studies with live
                # askers. Its first post-stale ask pays a miss — which
                # files a demand-priority request — exactly the documented
                # shed-ladder degradation, not a new failure mode.
                self._maybe_request_refill(study_id, handle)
            if self._health_reporting:
                from optuna_tpu_torch import health

                health.maybe_report(handle.study)
            # Tell-boundary autopilot step for the hub's own loop (one dict
            # lookup while disabled): the hub is where the service.* checks
            # have their actuator, so its control loop steps on the tells
            # its thin clients land.
            from optuna_tpu_torch import autopilot

            autopilot.maybe_step(handle.study, service=self)

    def _write_hub_checkpoint(self, study_id: int, handle: _StudyHandle) -> None:
        """Persist the handle's fitted sampler state + ready-queue epoch
        into the study's ``ckpt:hub`` ring (best-effort, tell-tick
        cadence). Skipped when the sampler exports no fitted state —
        there is nothing for a successor to warm-load. The export runs
        under ``handle.lock`` (it reads the one server-resident sampler's
        fit); the storage write deliberately does not."""
        with handle.lock:
            state = _ckpt.export_sampler_state(handle.guarded)
            epoch = handle.queue.epoch
        if state is None:
            return
        if handle.ckpt_seq is None:
            handle.ckpt_seq = _ckpt.max_slot_seq(self._storage, study_id, "hub") + 1
        # Fleet members swap in a lease-fenced storage (fleet.py): stamp the
        # held fencing epoch into the frame for provenance, and let the fence
        # itself reject the write when the claim went stale (write_checkpoint
        # absorbs the StaleLeaseError as its usual best-effort skip — the
        # fence already counted fleet.fenced_write and demoted the hub).
        fence_of = getattr(self._storage, "fence_epoch", None)
        _ckpt.write_checkpoint(
            self._storage,
            study_id,
            "hub",
            {"sampler": state, "epoch": int(epoch)},
            n_told=handle.tells_total,
            seq=handle.ckpt_seq,
            fence=int(fence_of(study_id)) if callable(fence_of) else 0,
        )
        handle.ckpt_seq += 1

    # ------------------------------------------------------------ lifecycle

    def drain(self) -> None:
        """Graceful-drain hook (SIGTERM): flush the open coalesce window so
        parked askers are answered, stop speculating, and shed any ask that
        arrives while the listener winds down."""
        self._draining = True
        with self._handles_lock:
            handles = list(self._handles.values())
        for handle in handles:
            handle.coalescer.drain()

    def close(self) -> None:
        self.drain()
        with self._refill_cond:
            self._closed = True
            self._refill_cond.notify_all()
        thread = self._refill_thread
        if thread is not None:
            thread.join(timeout=10.0)
        if self._health_reporting:
            from optuna_tpu_torch import health

            with self._handles_lock:
                handles = list(self._handles.values())
            for handle in handles:
                health.flush(handle.study)

    # --------------------------------------------------------- introspection

    def state(self) -> dict[str, Any]:
        """Queue depths and knobs, for tests' and benchmarks' introspection (not on
        the wire)."""
        with self._handles_lock:
            queues = {
                sid: {
                    "len": len(h.queue),
                    "fresh": h.queue.fresh_len(self.max_stale_epochs),
                    "stale": h.queue.stale_len(self.max_stale_epochs),
                    "epoch": h.queue.epoch,
                }
                for sid, h in self._handles.items()
            }
            coalescer_depth = sum(
                h.coalescer.depth for h in self._handles.values()
            )
        return {
            "inflight": self._inflight,
            "coalescer_depth": coalescer_depth,
            "ready_ahead": self.ready_ahead,
            "invalidate_after": self.invalidate_after,
            "max_stale_epochs": self.max_stale_epochs,
            "queues": queues,
            "draining": self._draining,
        }


# ------------------------------------------------------------- thin client


class ThinClientSampler(BaseSampler):
    """A client-side sampler whose relative path is one ``service_ask`` RPC.

    The server owns the surrogate: this sampler never reads history, never
    fits, and pays no per-ask storage fan-out — the hub coalesces its ask
    with every concurrent peer's into one fused dispatch (or answers from
    the speculative ready queue). The independent path (startup dims,
    server-shed asks) stays local on ``independent_sampler``.

    Shed handling: a ``reject`` response (``RESOURCE_EXHAUSTED``) sleeps a
    full-jitter draw over the carried ``retry_after_s`` (``shed_retry``'s
    :meth:`~optuna_tpu_torch.storages._retry.RetryPolicy.jitter`, injectable
    ``sleep``) and re-asks, up to
    ``max_shed_retries``; a still-overloaded server then degrades this one
    trial to the local independent path — the study never aborts on
    backpressure. Against a pre-service server the first ask's 'unknown
    method' answer downgrades the sampler to local independent sampling for
    its lifetime (warned once), mirroring the flight-context skew handling
    in :class:`~optuna_tpu_torch.storages._grpc.client.GrpcStorageProxy`.

    Every ask carries a fresh op token, minted once per *logical* ask: a
    transport retry replays the recorded response instead of burning a
    second ready-queue entry or minting a second proposal for the same
    trial.
    """

    def __init__(
        self,
        ask: Callable[..., dict] | None = None,
        *,
        proxy: Any | None = None,
        independent_sampler: BaseSampler | None = None,
        seed: int | None = None,
        max_shed_retries: int = 4,
        sleep: Callable[[float], None] = time.sleep,
        shed_retry: RetryPolicy | None = None,
    ) -> None:
        if (ask is None) == (proxy is None):
            raise ValueError("pass exactly one of `ask` (a callable) or `proxy`.")
        if proxy is not None:
            def ask(study_id: int, trial_id: int, number: int, token: str) -> dict:
                return proxy._call(
                    "service_ask", study_id, trial_id, number, **{OP_TOKEN_KEY: token}
                )
        assert ask is not None
        self._ask = ask
        if independent_sampler is None:
            from optuna_tpu_torch.samplers._random import RandomSampler

            independent_sampler = RandomSampler(seed=seed)
        self._independent_sampler = independent_sampler
        self.max_shed_retries = int(max_shed_retries)
        self._sleep = sleep
        # Full jitter on shed retry-after sleeps, through RetryPolicy's own
        # draw (per-instance OS-entropy rng by default): a burst of clients
        # shed on the same tick wakes decorrelated instead of as a
        # synchronized herd against the recovering hub. Deliberately NOT
        # derived from ``seed`` — reproducible sampling must not mean
        # reproducible (synchronized) retry timing.
        self._shed_retry = shed_retry if shed_retry is not None else RetryPolicy()
        self._service_unsupported = False
        self._warn_token = next(_service_seq)
        self._pending: dict[int, dict] = {}
        self._lock = locksan.lock("suggest.thin_client")
        #: Recent responses' source/shed tags (bounded) — test and benchmark
        #: visibility into how this client's asks were served.
        self.served_sources: deque[str] = deque(maxlen=1024)
        self.sheds_seen: int = 0

    def reseed_rng(self) -> None:
        self._independent_sampler.reseed_rng()

    def __str__(self) -> str:
        return f"ThinClientSampler({self._independent_sampler})"

    # ------------------------------------------------------------- the RPC

    def _ask_server(self, study: "Study", trial: "FrozenTrial") -> dict | None:
        if self._service_unsupported:
            return None
        attempts = 0
        while True:
            token = uuid.uuid4().hex
            try:
                resp = self._ask(study._study_id, trial._trial_id, trial.number, token)
            except Exception as err:  # degradation boundary: any server/transport failure on the suggestion path but a device fault falls back to local independent sampling, never aborts the client's trial
                if is_device_fault(err):
                    # The hub's card (or a kernel) failed: that is never
                    # contained, here as in GuardedSampler.
                    raise
                if _is_unknown_method_error(err):
                    self._service_unsupported = True
                    warn_once(
                        _logger,
                        f"thin_client_no_service:{self._warn_token}",
                        "server does not mount a suggestion service; "
                        "ThinClientSampler degrades to local independent "
                        "sampling for its lifetime.",
                    )
                else:
                    warn_once(
                        _logger,
                        f"thin_client_ask_failed:{self._warn_token}:{study._study_id}",
                        f"service_ask failed ({type(err).__name__}: {err}); "
                        "this trial samples independently.",
                    )
                return None
            if not isinstance(resp, dict):
                return None
            if resp.get("shed") == "reject":
                self.sheds_seen += 1
                if attempts >= self.max_shed_retries:
                    return None
                attempts += 1
                self._sleep(
                    self._shed_retry.jitter(float(resp.get("retry_after_s") or 0.05))
                )
                continue
            return resp

    # ----------------------------------------------------------------- hooks

    def infer_relative_search_space(
        self, study: "Study", trial: "FrozenTrial"
    ) -> dict[str, BaseDistribution]:
        resp = self._ask_server(study, trial)
        if resp is None:
            return {}
        self.served_sources.append(resp.get("shed") or resp.get("source") or "?")
        space = {
            name: json_to_distribution(dist_json)
            for name, dist_json in (resp.get("dists") or {}).items()
        }
        with self._lock:
            self._pending[trial._trial_id] = resp
        return space

    def sample_relative(
        self,
        study: "Study",
        trial: "FrozenTrial",
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        with self._lock:
            resp = self._pending.pop(trial._trial_id, None)
        if resp is None:
            return {}
        return dict(resp.get("params") or {})

    def sample_independent(
        self,
        study: "Study",
        trial: "FrozenTrial",
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        return self._independent_sampler.sample_independent(
            study, trial, param_name, param_distribution
        )

    def before_trial(self, study: "Study", trial: "FrozenTrial") -> None:
        self._independent_sampler.before_trial(study, trial)

    def after_trial(
        self,
        study: "Study",
        trial: "FrozenTrial",
        state: "TrialState",
        values: Sequence[float] | None,
    ) -> None:
        with self._lock:
            self._pending.pop(trial._trial_id, None)
        self._independent_sampler.after_trial(study, trial, state, values)


def _is_unknown_method_error(err: BaseException) -> bool:
    text = str(err)
    return "Unknown method" in text and "service_ask" in text
