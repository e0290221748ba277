"""Study doctor: fleet-wide telemetry aggregation and optimization-health
checks (port of ``optuna_tpu/health.py``; standard library only).

The telemetry registry, the flight recorder and the device-stats taps are
process-local, but a study is a multi-worker object (``n_jobs`` threads,
processes sharing a storage, retry clones), and a worker drowning in
quarantines or sampler fallbacks is invisible to every other worker. This
module is the study-scoped sibling of ``Study.telemetry_snapshot()``:

* **Worker reporter** — :class:`HealthReporter` publishes each process's
  bounded telemetry snapshot (containment counters, ``device.*``/``jit.*``/
  ``hbm.*`` gauges, phase histograms, jit compile totals, worker id,
  last-seen timestamp) into storage as namespaced study system attrs
  (``health:worker:<id>``): the fleet view rides the storage every backend
  already shares, so it needs no wire protocol of its own. The attrs are
  the reference's, key for key, so either package's doctor reads the
  other's storage.
* **Aggregator** — :func:`fleet_snapshot` merges the per-worker snapshots
  into one fleet view: counters sum, ``.max``/``.last`` gauges take the
  max, everything else sums, histograms merge by bucket, and per-worker
  liveness derives from last-seen age against the published report
  interval.
* **Diagnostics engine** — :func:`diagnose` runs rules over the aggregate
  and the trial history and emits structured :class:`HealthFinding`
  values (check id, severity, evidence, remediation hint). The check-id
  vocabulary :data:`HEALTH_CHECKS` is the reference's, each with a
  scenario in ``testing/fault_injection.py::HEALTH_CHECK_CHAOS_MATRIX``.
  The serve-tier checks are pure functions of the fleet view; the hubs of
  :mod:`optuna_tpu_torch.storages._grpc` publish what they read.

Surfaces: ``Study.health_report()``, the ``optuna-tpu-torch doctor`` CLI
(text/json, ``--endpoint`` like ``metrics``/``trace``), ``/health.json``
from ``telemetry.serve_metrics``, and a ``warn_once`` per CRITICAL finding
while ``optimize``/``optimize_vectorized``/``optimize_scan`` run with the
reporter enabled.

**Off by default**; the disabled hot path (:func:`maybe_report` at
trial/batch/chunk boundaries) is one module-global check and allocates
nothing per trial. Enabled, publishing is rate-limited by ``interval_s``
and best-effort: a storage blip on the health attr write is warn_once'd,
never study-fatal. Enable with ``OPTUNA_TPU_TORCH_HEALTH=1``
(``OPTUNA_TPU_TORCH_HEALTH_INTERVAL_S`` overrides the cadence) or
:func:`enable` / :func:`disable` at runtime.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

from optuna_tpu_torch import locksan, telemetry
from optuna_tpu_torch.logging import get_logger, warn_once

if TYPE_CHECKING:
    from optuna_tpu_torch.storages._base import BaseStorage
    from optuna_tpu_torch.study._study_direction import StudyDirection
    from optuna_tpu_torch.study.study import Study
    from optuna_tpu_torch.trial._frozen import FrozenTrial

_logger = get_logger(__name__)

__all__ = [
    "CHECK_SEVERITIES",
    "HEALTH_CHECKS",
    "HUB_WORKER_ID_SUFFIX",
    "SEVERITIES",
    "WORKER_ATTR_PREFIX",
    "HealthFinding",
    "HealthReporter",
    "attach",
    "diagnose",
    "disable",
    "enable",
    "enabled",
    "fleet_snapshot",
    "flush",
    "health_report",
    "maybe_report",
    "render_text",
    "report_for_study",
    "storage_health_reports",
    "worker_snapshots",
]


# ------------------------------------------------------------- vocabulary

#: The diagnostic check-id vocabulary: every finding the doctor can emit
#: carries exactly one of these ids. Equal to the reference's (the stored
#: reports of both packages compare), and ``tests/test_torch_health.py``
#: asserts the rule table below covers exactly this set.
HEALTH_CHECKS: dict[str, str] = {
    "study.stagnation": "no new best value over the trailing window of completed tells",
    "sampler.fallback_storm": "the configured sampler is degrading to the independent path at storm rate",
    "sampler.duplicate_proposals": "completed trials repeat earlier parameter points at high rate",
    "executor.quarantine_rate": "non-finite quarantines + heartbeat reaps are consuming the budget",
    "executor.dispatch_timeouts": "repeated dispatch-deadline strikes (each abandons a watchdog thread)",
    "jit.retrace_churn": "jit wrappers keep retracing after their first compile (runtime TPU002)",
    "gp.ladder_escalation": "the Cholesky jitter ladder is escalating rungs on real fits",
    "gp.sparse_degraded": "the sparse GP's one-step-ahead held-out error says the inducing set no longer covers the search",
    "worker.dead": "a worker's health snapshot went stale past its report interval",
    "shard.imbalance": "one trial shard's throughput fell >= 2x below the mesh median",
    "service.backpressure": "the suggestion service is shedding asks (overload ladder engaged)",
    "service.ready_queue_starved": "steady-state asks keep missing the speculative ready queue",
    "service.slo_burn": "an SLO is burning its error budget (severity escalates with the burn rate)",
    "service.hub_dead": "a suggestion hub's -serve snapshot went stale: the fleet re-homes its studies to ring successors",
    "checkpoint.stale": "resume is rejecting checkpoint blobs (torn, corrupt, or watermark-stale): restores are paying full recomputes",
    "service.hub_flapping": "a study's lease bounced between hubs repeatedly inside the window: asymmetric partition or liveness disagreement, not a clean failover",
    "service.hub_zombie_fenced": "a deposed hub is still writing serve state: the lease fence is rejecting its stale-epoch writes",
    "service.partition_suspected": "a lease takeover displaced a hub whose -serve snapshot is still fresh: partition, not crash",
}

#: Finding severities, mildest first. CRITICAL findings are additionally
#: ``warn_once``'d while the reporter runs (the study is actively burning
#: budget on something the operator would stop if they saw it).
SEVERITIES: tuple[str, ...] = ("INFO", "WARNING", "CRITICAL")

#: The severity *ceiling* each check reports at — for every check but one
#: this is its fixed severity; ``service.slo_burn`` escalates WARNING ->
#: CRITICAL with the burn rate (a slow leak is a warning, a fast burn is a
#: page) and the table records its ceiling. The hot path derives its
#: CRITICAL-capable subset from this map (see
#: :func:`_warn_critical_findings`) without running every check. Keyed
#: exactly by :data:`HEALTH_CHECKS` (asserted by ``tests/test_torch_health.py``).
CHECK_SEVERITIES: dict[str, str] = {
    "study.stagnation": "WARNING",
    "sampler.fallback_storm": "CRITICAL",
    "sampler.duplicate_proposals": "WARNING",
    "executor.quarantine_rate": "WARNING",
    "executor.dispatch_timeouts": "WARNING",
    "jit.retrace_churn": "WARNING",
    "gp.ladder_escalation": "WARNING",
    "gp.sparse_degraded": "WARNING",
    "worker.dead": "CRITICAL",
    "shard.imbalance": "WARNING",
    "service.backpressure": "WARNING",
    "service.ready_queue_starved": "WARNING",
    "service.slo_burn": "CRITICAL",
    "service.hub_dead": "CRITICAL",
    "checkpoint.stale": "WARNING",
    "service.hub_flapping": "WARNING",
    "service.hub_zombie_fenced": "WARNING",
    "service.partition_suspected": "WARNING",
}

#: Study system-attr namespace the reporter publishes under; one attr per
#: worker (``health:worker:<worker id>``), overwritten in place so the
#: storage holds exactly the latest snapshot per worker, not a history.
WORKER_ATTR_PREFIX = "health:worker:"

#: Worker-id suffix a suggestion hub publishes under (the service attaches
#: as ``<hub name>-serve``): the fleet layer and the ``service.hub_dead``
#: check derive hub liveness from exactly these snapshots — a stale
#: ``-serve`` snapshot is a dead *hub*, not just a dead worker.
HUB_WORKER_ID_SUFFIX = "-serve"

#: Default publish cadence. Deliberately coarser than a heartbeat: a health
#: snapshot is a diagnosis input, not a liveness primitive — the heartbeat
#: layer owns reaping, the doctor only *reports* staleness.
DEFAULT_INTERVAL_S = 15.0

#: A worker is reported dead when its snapshot age exceeds this multiple of
#: the interval it promised to publish at (grace for GC pauses, storage
#: retries, a slow batch between boundaries).
LIVENESS_GRACE_FACTOR = 2.5

# Diagnostic thresholds. Plain module constants, documented here and in
# ARCHITECTURE.md's check table, so an operator reading a finding can see
# exactly what tripped it; `diagnose` takes overrides for tests.
STAGNATION_WINDOW = 16  # completed tells without a new best before flagging
# Containment guard on the stagnation check: when the trailing finished
# window is FAIL-dominated (an active NaN burst being quarantined), the
# sampler never got a fair run of tells, so "no new best" is containment
# evidence (executor.quarantine_rate's story), not stagnation — flagging it
# would make the autopilot restart a sampler mid-containment.
STAGNATION_CONTAINMENT_MIN = 4  # FAILs in the trailing window, and...
STAGNATION_CONTAINMENT_FRACTION = 0.5  # ...at least this share of it
FALLBACK_STORM_RATE = 0.25  # fallbacks per finished trial
FALLBACK_STORM_MIN = 4  # ...and at least this many in absolute terms
QUARANTINE_RATE = 0.10  # quarantines+reaps per finished trial
QUARANTINE_MIN = 3
DISPATCH_TIMEOUT_STRIKES = 2  # watchdog strikes before flagging
RETRACE_CHURN_MIN = 3  # retraces-after-first across all jit labels
LADDER_RUNG_WARN = 3  # device.gp.ladder_rung.max at or above this escalates
# Sparse-GP degradation: the scan loop's gp.sparse_heldout_err gauge is a
# one-step-ahead |predicted - observed| residual in STANDARDIZED score units
# (unit variance by construction) measured before each tell. A healthy
# approximation predicts new points well under one standard deviation off;
# sustained error at/above one full standard deviation means the inducing
# set has stopped covering where the optimizer is searching — the trigger
# for the autopilot's gp.densify action.
SPARSE_HELDOUT_ERR_WARN = 1.0
DUPLICATE_RATE = 0.25  # exact-duplicate completed trials per completed trial
DUPLICATE_MIN = 4
SHARD_IMBALANCE_FACTOR = 2.0  # a shard this far below the median is lagging
SHARD_IMBALANCE_MIN_TRIALS = 8  # ...once the BEST shard has done this much
BACKPRESSURE_SHED_MIN = 3  # shed asks before the service is flagged overloaded
READY_QUEUE_MISS_MIN = 8  # ready-queue misses before starvation can flag
READY_QUEUE_MISS_RATE = 0.5  # ...and misses must be this share of lookups
SLO_BURN_MIN_VIOLATIONS = 3  # fleet-wide long-window violations before slo_burn can flag
# A single rejected/stale checkpoint blob already flags: each one means a
# resume (or hub re-home) silently paid a full recompute instead of a
# restore — invisible in the study's results, expensive at the next
# preemption, and usually systematic (torn writes, version drift, a
# watermark bug) rather than a one-off.
CHECKPOINT_REJECT_MIN = 1
# Lease flapping: takeovers are normal one at a time (a failover, a
# failback); this many inside the window means ownership is oscillating —
# two hubs disagree about liveness, usually an asymmetric partition — and
# every bounce pays a warm-load plus a fence-demotion round trip.
HUB_FLAP_MIN_TAKEOVERS = 3
HUB_FLAP_WINDOW_S = 600.0

#: Gauge prefixes a worker snapshot carries (bounded: the device-stat,
#: jit-label and mesh-coordinate vocabularies are small by construction;
#: everything else — ad-hoc gauges like ``batch_size`` — stays
#: process-local).
_SNAPSHOT_GAUGE_PREFIXES = ("device.", "jit.", "hbm.", "shard.", "serve.")
_PHASE_HISTOGRAM_PREFIX = "phase."


@dataclass(frozen=True)
class HealthFinding:
    """One structured diagnostic: what tripped, how bad, the numbers that
    prove it, and what an operator should do about it."""

    check: str
    severity: str
    summary: str
    evidence: dict[str, Any] = field(default_factory=dict)
    remediation: str = ""

    def __post_init__(self) -> None:
        if self.check not in HEALTH_CHECKS:
            raise ValueError(
                f"unknown health check {self.check!r}; the vocabulary is "
                f"{sorted(HEALTH_CHECKS)} (HEALTH_CHECKS / HEALTH_CHECK_REGISTRY)."
            )
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r}; must be one of {SEVERITIES}."
            )

    def to_dict(self) -> dict[str, Any]:
        return {
            "check": self.check,
            "severity": self.severity,
            "summary": self.summary,
            "evidence": dict(self.evidence),
            "remediation": self.remediation,
        }


# ------------------------------------------------------- worker reporter


class HealthReporter:
    """Publishes this process's telemetry snapshot into the study's storage.

    One reporter = one (study, worker) pair. ``clock`` (monotonic, for the
    publish rate limit) and ``now`` (wall, for the last-seen stamp) are
    injectable like :class:`~optuna_tpu_torch.telemetry.MetricsRegistry`'s clock,
    so tests drive publishes and staleness deterministically. Publishing is
    best-effort by contract: the health attr is diagnostics, and a storage
    blip on it must never become a study failure.

    Snapshots are **deltas since the reporter attached** (the telemetry
    registry is process-global by design, so a reporter constructed when
    its study's run begins — :func:`attach` does this at every optimize
    loop's entry — baselines the registry and publishes only what moved
    since): a second study driven by the same process must not inherit the
    first study's quarantine/fallback counts into its own rates. Two
    studies optimizing *concurrently* in one process still share the
    registry and therefore each other's deltas — the distributed layout is
    one study per worker process, and the doctor inherits that assumption.
    """

    def __init__(
        self,
        study: "Study",
        *,
        worker_id: str | None = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        clock: Callable[[], float] = time.monotonic,
        now: Callable[[], float] = time.time,
    ) -> None:
        from optuna_tpu_torch import flight

        self._study = study
        self.worker_id = worker_id if worker_id is not None else default_worker_id()
        self.interval_s = float(interval_s)
        self._clock = clock
        self._now = now
        self._last_publish: float | None = None
        self._max_observed_gap = 0.0
        self._seq = 0
        self._lock = locksan.lock("health.doctor")
        # The delta baseline: everything the process-global registry held
        # when this reporter attached to its study belongs to whatever ran
        # before, not to this study's fleet rates.
        from optuna_tpu_torch import slo

        baseline = telemetry.snapshot()
        self._baseline_counters: dict[str, int] = dict(baseline.get("counters", {}))
        self._baseline_gauges: dict[str, float] = dict(baseline.get("gauges", {}))
        self._baseline_histograms: dict[str, dict] = baseline.get("histograms", {})
        self._baseline_jit: dict[str, dict] = flight.jit_totals()
        self._baseline_slo: dict[str, tuple[int, int]] = slo.cumulative_counts()

    def snapshot(self, *, final: bool = False, observed_gap: float = 0.0) -> dict[str, Any]:
        """This worker's bounded health snapshot: the JSON-able dict the
        aggregator merges. Bounded by construction — counters come from the
        registered families, gauges are filtered to the ``device.``/``jit.``/
        ``hbm.`` vocabularies, histograms to the ``phase.`` set — so the
        study attr stays kilobytes no matter how long the worker runs.
        Cumulative series (counters, ``.total`` gauges, ``jit.*`` gauges,
        histograms, jit totals) are published as deltas vs the attach-time
        baseline; level/high-water gauges (``.max``/``.last``/``hbm.*``)
        publish their current value only when it moved since attach.
        ``final`` marks a clean exit (see :func:`flush`): the aggregator
        reports the worker *exited* instead of letting the snapshot age
        into a false ``worker.dead``."""
        from optuna_tpu_torch import flight

        snap = telemetry.snapshot()
        counters = {}
        for name, value in snap.get("counters", {}).items():
            delta = value - self._baseline_counters.get(name, 0)
            if delta > 0:
                counters[name] = delta
        gauges = {}
        for name, value in snap.get("gauges", {}).items():
            if not name.startswith(_SNAPSHOT_GAUGE_PREFIXES):
                continue
            base = self._baseline_gauges.get(name)
            if name.endswith(".total") or name.startswith("jit."):
                delta = value - (base or 0.0)
                if delta > 0:
                    gauges[name] = delta
            elif base is None or value != base:
                gauges[name] = value
        histograms = {}
        for name, hist in snap.get("histograms", {}).items():
            if not name.startswith(_PHASE_HISTOGRAM_PREFIX):
                continue
            base_hist = self._baseline_histograms.get(name)
            if base_hist is not None:
                base_buckets = base_hist.get("buckets", {})
                hist = {
                    "count": hist["count"] - base_hist.get("count", 0),
                    "sum": hist["sum"] - base_hist.get("sum", 0.0),
                    "buckets": {
                        bound: count - base_buckets.get(bound, 0)
                        for bound, count in hist["buckets"].items()
                    },
                }
            if hist["count"] > 0:
                histograms[name] = hist
        jit = {}
        for label, totals in flight.jit_totals().items():
            base_totals = self._baseline_jit.get(label, {})
            delta = {
                "compiles": totals["compiles"] - base_totals.get("compiles", 0),
                "compile_seconds": round(
                    totals["compile_seconds"]
                    - base_totals.get("compile_seconds", 0.0),
                    6,
                ),
                "retraces_after_first": totals["retraces_after_first"]
                - base_totals.get("retraces_after_first", 0),
            }
            if delta["compiles"] > 0 or delta["retraces_after_first"] > 0:
                jit[label] = delta
        out = {
            "worker": self.worker_id,
            "pid": os.getpid(),
            "seq": self._seq,
            "last_seen_unix": self._now(),
            "interval_s": self._promised_interval(observed_gap),
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
            "jit": jit,
        }
        from optuna_tpu_torch import slo as slo_module

        # The SLO engine's verdicts ride the same fleet channel: good/bad
        # deltas vs the attach baseline plus this worker's current windowed
        # burn rates, so the doctor's service.slo_burn check sees a burning
        # serving hub from any process that can read the storage.
        slo_block = slo_module.worker_snapshot(self._baseline_slo)
        if slo_block:
            out["slo"] = slo_block
        if final:
            out["final"] = True
        return out

    def _promised_interval(self, observed_gap: float) -> float:
        """The cadence the liveness grace is measured against. The reporter
        only publishes at trial/batch boundaries, so a 60s objective makes
        the configured 15s a promise it cannot keep — the published
        interval adapts to the **slowest** observed publish gap (a running
        max, not the latest gap: an alternating slow/fast objective must
        not shrink the grace back after every fast trial and re-flag the
        next slow one), and the aggregator's grace stretches with it. One
        window remains: the *first* trial slower than the current grace can
        read dead until its boundary publishes (documented in
        ARCHITECTURE.md's liveness note)."""
        self._max_observed_gap = max(self._max_observed_gap, observed_gap)
        return max(self.interval_s, self._max_observed_gap)

    def maybe_publish(self) -> bool:
        """Publish if ``interval_s`` has elapsed since the last publish (the
        first call always publishes). Returns True when a publish happened."""
        with self._lock:
            t = self._clock()
            if (
                self._last_publish is not None
                and t - self._last_publish < self.interval_s
            ):
                return False
        self.publish()
        return True

    def publish(self, *, final: bool = False) -> dict[str, Any] | None:
        """Write this worker's snapshot attr now (unconditionally). Returns
        the snapshot written, or None when the storage write failed — the
        failure is warn_once'd and swallowed (diagnostics must never abort
        the study they diagnose)."""
        with self._lock:
            t = self._clock()
            observed_gap = 0.0 if self._last_publish is None else t - self._last_publish
            self._last_publish = t
            self._seq += 1
        snapshot = self.snapshot(final=final, observed_gap=observed_gap)
        try:
            self._study._storage.set_study_system_attr(
                self._study._study_id, WORKER_ATTR_PREFIX + self.worker_id, snapshot
            )
        except Exception as err:  # graphlint: ignore[PY001] -- best-effort diagnostics write: any storage failure here degrades to "no fresh snapshot", never a study abort; the aggregator reports the resulting staleness
            warn_once(
                _logger,
                f"health_publish:{self._study._study_id}:{self.worker_id}",
                f"publishing the health snapshot for worker {self.worker_id!r} "
                f"raised {err!r}; the study continues, but the fleet view will "
                "report this worker stale until a publish succeeds.",
            )
            return None
        return snapshot


def default_worker_id() -> str:
    """``<hostname>-<pid>``: unique per process across the hosts of one
    study, stable for the process lifetime (a retried trial keeps its
    worker), and human-legible in the doctor's worker table."""
    try:
        host = socket.gethostname() or "host"
    except OSError:
        host = "host"
    return f"{host}-{os.getpid()}"


# ------------------------------------------------- module-level fast path

_enabled = False
_interval_s = DEFAULT_INTERVAL_S
_worker_id: str | None = None
_clock: Callable[[], float] = time.monotonic
_now: Callable[[], float] = time.time


def _env_enabled() -> bool:
    """``OPTUNA_TPU_TORCH_HEALTH``: unset/empty/0/false/no/off stay disabled (the
    flight recorder's opt-out spellings — an explicit disable must not arm
    the reporter), anything else enables."""
    raw = os.environ.get("OPTUNA_TPU_TORCH_HEALTH", "").strip()
    return bool(raw) and raw.lower() not in ("0", "false", "no", "off")


def enabled() -> bool:
    return _enabled


def enable(
    *,
    interval_s: float | None = None,
    worker_id: str | None = None,
    clock: Callable[[], float] | None = None,
    now: Callable[[], float] | None = None,
) -> None:
    """Turn the reporter on for studies this process subsequently drives.
    ``interval_s``/``worker_id``/``clock``/``now`` seed the reporters
    :func:`maybe_report` lazily creates (tests inject deterministic clocks
    here; a study already carrying a reporter keeps it)."""
    global _enabled, _interval_s, _worker_id, _clock, _now
    if interval_s is not None:
        _interval_s = float(interval_s)
    if worker_id is not None:
        _worker_id = worker_id
    if clock is not None:
        _clock = clock
    if now is not None:
        _now = now
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


#: Sentinel marking a study whose reporting is suppressed (see
#: :func:`suppress`): distinct from "no reporter yet" so the lazy hooks
#: don't resurrect one.
_SUPPRESSED = object()


def _reporter_for(
    study: "Study", worker_id: str | None = None
) -> HealthReporter | None:
    reporter = study.__dict__.get("_health_reporter")
    if reporter is _SUPPRESSED:
        return None
    if reporter is None:
        reporter = HealthReporter(
            study,
            worker_id=worker_id if worker_id is not None else _worker_id,
            interval_s=_interval_s,
            clock=_clock,
            now=_now,
        )
        study.__dict__["_health_reporter"] = reporter
    return reporter


def suppress(study: "Study") -> None:
    """Mark ``study`` so :func:`maybe_report`/:func:`flush` publish nothing
    for it even while the reporter is globally enabled. For loops whose
    storage-write sequence must stay deterministic across processes (the
    sharded tier's lockstep pod, ``parallel.sharded.optimize_sharded``,
    where a wall-clock rate-limited publish on one rank would
    desynchronize the exchange count). Undo by clearing ``study.__dict__['_health_reporter']``."""
    study.__dict__["_health_reporter"] = _SUPPRESSED


def attach(study: "Study", *, worker_id: str | None = None) -> None:
    """Attach a reporter to ``study`` now (no publish yet): called at every
    optimize loop's entry so the delta baseline is captured *before* the
    run records anything — counters a previous study left in the
    process-global registry must not leak into this study's snapshots. A
    no-op while disabled; idempotent (an existing reporter keeps its
    baseline and its id). ``worker_id`` overrides the default
    ``<host>-<pid>`` identity for loops whose worker has a richer address —
    the sharded loop passes ``<host>-<pid>-t<i>m<j>`` so the fleet table
    maps onto mesh coordinates."""
    if not _enabled:
        return
    _reporter_for(study, worker_id=worker_id)


def maybe_report(study: "Study") -> None:
    """The trial/batch-boundary hook ``Study.optimize`` and the batch
    executor call: rate-limited publish + CRITICAL-finding warn pass. A
    no-op (one module-global check, zero allocations) while disabled."""
    if not _enabled:
        return
    reporter = _reporter_for(study)
    if reporter is not None and reporter.maybe_publish():
        _warn_critical_findings(study)


def flush(study: "Study") -> None:
    """Publish the terminal snapshot immediately (end of an optimize loop),
    marked ``final``: the worker *exited* — the aggregator must not let the
    snapshot age into a false ``worker.dead``. A no-op while disabled;
    best-effort like every reporter write."""
    if not _enabled:
        return
    reporter = _reporter_for(study)
    if reporter is not None:
        reporter.publish(final=True)


#: The checks whose findings can be CRITICAL (derived from the severity
#: table): the hot path's warn pass evaluates only these — stagnation and
#: duplicate scans are O(trials) and only ever WARNING, so re-running them
#: per publish would tax the optimize loop for findings it never warns on.
_CRITICAL_CAPABLE: tuple[str, ...] = tuple(
    check for check, severity in CHECK_SEVERITIES.items() if severity == "CRITICAL"
)


def _warn_critical_findings(study: "Study") -> None:
    """Surface CRITICAL findings into the worker's own log, once per
    (study, check) — the operator watching any worker's stderr learns the
    study is sick without running the doctor. Only the CRITICAL-capable
    checks run here (the full battery belongs to the report surfaces).
    Best-effort: diagnosis reads storage, and a blip there must not fail
    the loop that called us."""
    try:
        storage, study_id = study._storage, study._study_id
        fleet = fleet_snapshot(storage, study_id)
        trials = storage.get_all_trials(study_id, deepcopy=False)
        findings = diagnose(
            fleet, trials, study.directions, checks=_CRITICAL_CAPABLE
        )
    except Exception as err:  # graphlint: ignore[PY001] -- best-effort diagnosis on the hot path's rate-limited branch: a storage blip while *reading* the fleet view must not abort the optimize loop
        _logger.info(f"health diagnosis skipped after read error: {err!r}")
        return
    for finding in findings:
        if finding.severity != "CRITICAL":
            continue
        warn_once(
            _logger,
            f"health_finding:{study._study_id}:{finding.check}",
            f"study doctor: CRITICAL [{finding.check}] {finding.summary} "
            f"— {finding.remediation} (run `optuna-tpu-torch doctor` for the "
            "full report; this warning fires once per study+check, the "
            "report keeps the live numbers.)",
        )


# ------------------------------------------------------------ aggregator


def worker_snapshots(storage: "BaseStorage", study_id: int) -> dict[str, dict]:
    """The raw per-worker snapshots currently in storage, keyed by worker
    id. Non-dict values under the namespace are skipped (a corrupt attr must
    not take the doctor down with it)."""
    out: dict[str, dict] = {}
    for key, value in storage.get_study_system_attrs(study_id).items():
        if not key.startswith(WORKER_ATTR_PREFIX):
            continue
        if not isinstance(value, Mapping):
            # Once per attr, not once per scrape: /health.json re-aggregates
            # every few seconds, and one corrupt attr must not flood the log.
            warn_once(
                _logger,
                f"health_malformed_attr:{study_id}:{key}",
                f"ignoring malformed health snapshot attr {key!r} "
                f"(expected a dict, got {type(value).__name__})",
            )
            continue
        out[key[len(WORKER_ATTR_PREFIX):]] = dict(value)
    return out


def _merge_gauge(name: str) -> str:
    # `.max` gauges are high-water marks and `.last` gauges point values —
    # neither has a meaningful cross-worker sum, so both merge by max (the
    # worst worker is the story). Everything else (`.total` device stats,
    # `jit.compiles.<label>`, `hbm.*` bytes) is additive work.
    if name.endswith((".max", ".last")):
        return "max"
    return "sum"


def fleet_snapshot(
    storage: "BaseStorage", study_id: int, *, now: float | None = None
) -> dict[str, Any]:
    """Merge every worker's published snapshot into one fleet view.

    Counters sum; gauges merge per :func:`_merge_gauge`; histograms merge
    bucket-by-bucket (counts and sums add; the bucket bounds are fixed
    module-wide, so keys always line up); ``jit`` per-label totals sum.
    Liveness: a worker is ``alive`` while its snapshot age is within
    :data:`LIVENESS_GRACE_FACTOR` x the interval it published (falling back
    to :data:`DEFAULT_INTERVAL_S` for snapshots that omit it); a snapshot
    marked ``final`` (the terminal :func:`flush`) is an *exited* worker —
    neither alive nor dead, its clean exit must not age into a false
    ``worker.dead``.
    """
    now = time.time() if now is None else now
    workers: list[dict[str, Any]] = []
    counters: dict[str, int] = {}
    gauges: dict[str, float] = {}
    histograms: dict[str, dict] = {}
    jit: dict[str, dict[str, float]] = {}
    slo: dict[str, dict[str, Any]] = {}
    for worker_id, snap in sorted(worker_snapshots(storage, study_id).items()):
        last_seen = float(snap.get("last_seen_unix", 0.0))
        interval = float(snap.get("interval_s", DEFAULT_INTERVAL_S)) or DEFAULT_INTERVAL_S
        age = max(0.0, now - last_seen)
        exited = bool(snap.get("final"))
        workers.append(
            {
                "worker": worker_id,
                "pid": snap.get("pid"),
                "seq": snap.get("seq"),
                "last_seen_unix": last_seen,
                "age_s": round(age, 3),
                "interval_s": interval,
                "exited": exited,
                "alive": not exited and age <= LIVENESS_GRACE_FACTOR * interval,
            }
        )
        for name, value in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + int(value)
        for name, value in (snap.get("gauges") or {}).items():
            value = float(value)
            if _merge_gauge(name) == "max":
                current = gauges.get(name)
                if current is None or value > current:
                    gauges[name] = value
            else:
                gauges[name] = gauges.get(name, 0.0) + value
        for name, hist in (snap.get("histograms") or {}).items():
            merged = histograms.setdefault(
                name, {"count": 0, "sum": 0.0, "buckets": {}}
            )
            merged["count"] += int(hist.get("count", 0))
            merged["sum"] += float(hist.get("sum", 0.0))
            for bound, bucket_count in (hist.get("buckets") or {}).items():
                merged["buckets"][bound] = (
                    merged["buckets"].get(bound, 0) + int(bucket_count)
                )
        for label, totals in (snap.get("jit") or {}).items():
            agg = jit.setdefault(
                label, {"compiles": 0, "compile_seconds": 0.0, "retraces_after_first": 0}
            )
            agg["compiles"] += int(totals.get("compiles", 0))
            agg["compile_seconds"] = round(
                agg["compile_seconds"] + float(totals.get("compile_seconds", 0.0)), 6
            )
            agg["retraces_after_first"] += int(totals.get("retraces_after_first", 0))
        for spec_id, entry in (snap.get("slo") or {}).items():
            # Counts are additive work across the fleet; burn rates and the
            # quantile estimate merge by max — the worst worker's windowed
            # burn is the story (a healthy replica must not dilute a
            # burning hub's verdict), mirroring `.max` gauge semantics.
            # The burning/critical VERDICTS merge by OR of the per-worker
            # booleans, not by re-ANDing the maxed windows: one worker's
            # long-window spike plus another's short-window blip must not
            # combine into a verdict no single worker holds.
            agg = slo.setdefault(
                spec_id,
                {"good": 0, "bad": 0, "burn_long": 0.0, "burn_short": 0.0,
                 "estimate_s": 0.0, "burning": False, "critical": False},
            )
            agg["good"] += int(entry.get("good", 0))
            agg["bad"] += int(entry.get("bad", 0))
            agg["burn_long"] = max(agg["burn_long"], float(entry.get("burn_long", 0.0)))
            agg["burn_short"] = max(agg["burn_short"], float(entry.get("burn_short", 0.0)))
            agg["estimate_s"] = max(agg["estimate_s"], float(entry.get("estimate_s", 0.0)))
            agg["burning"] = agg["burning"] or bool(entry.get("burning"))
            agg["critical"] = agg["critical"] or bool(entry.get("critical"))
            for key in ("objective", "target_s", "quantile"):
                if key in entry:
                    agg[key] = entry[key]
    # Lazy: fleet.py imports this module for the liveness grace factor.
    from optuna_tpu_torch.storages._grpc.fleet import read_lease

    return {
        "workers": workers,
        "n_workers": len(workers),
        "n_alive": sum(1 for w in workers if w["alive"]),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "jit": jit,
        "slo": slo,
        "lease": read_lease(storage, study_id),
    }


# ----------------------------------------------------- diagnostics engine


def _counter_family_total(counters: Mapping[str, int], family: str) -> int:
    return sum(
        value
        for name, value in counters.items()
        if name == family or name.startswith(family + ".")
    )


def _check_stagnation(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    window = kw.get("stagnation_window", STAGNATION_WINDOW)
    if len(directions) > 1:
        return None  # Pareto stagnation needs a dominance notion; out of scope
    from optuna_tpu_torch.study._study_direction import StudyDirection
    from optuna_tpu_torch.trial._state import TrialState

    completed = [
        t for t in trials if t.state == TrialState.COMPLETE and t.values
    ]
    if len(completed) <= window:
        return None
    completed.sort(key=lambda t: t.number)
    # Containment-heavy trailing window: while active NaN containment is
    # quarantining a FAIL-dominated stretch of tells, the no-new-best
    # window is measuring the containment layers, not the sampler — skip
    # (executor.quarantine_rate owns that story; an autopilot restarting
    # the sampler mid-containment would remediate the wrong layer).
    finished = sorted(
        (t for t in trials if t.state.is_finished()), key=lambda t: t.number
    )
    recent = finished[-window:]
    recent_fails = sum(1 for t in recent if t.state == TrialState.FAIL)
    if (
        recent_fails >= STAGNATION_CONTAINMENT_MIN
        and recent_fails >= STAGNATION_CONTAINMENT_FRACTION * len(recent)
    ):
        return None
    maximize = directions[0] == StudyDirection.MAXIMIZE
    best_before = None
    for t in completed[:-window]:
        v = t.values[0]
        if best_before is None or (v > best_before if maximize else v < best_before):
            best_before = v
    for t in completed[-window:]:
        v = t.values[0]
        if v > best_before if maximize else v < best_before:
            return None  # the window improved: not stagnant
    return HealthFinding(
        check="study.stagnation",
        severity=CHECK_SEVERITIES["study.stagnation"],
        summary=(
            f"no new best value in the last {window} completed trials "
            f"(best still {best_before})"
        ),
        evidence={
            "window": window,
            "n_complete": len(completed),
            "best_value": best_before,
        },
        remediation=(
            "the search has plateaued: widen the search space, switch sampler "
            "family (GP -> ES/CMA-ES for high-dim), or stop and bank the budget"
        ),
    )


def _check_fallback_storm(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    fallbacks = _counter_family_total(fleet["counters"], "sampler.fallback")
    finished = sum(1 for t in trials if t.state.is_finished())
    rate = fallbacks / max(1, finished)
    if fallbacks < FALLBACK_STORM_MIN or rate < FALLBACK_STORM_RATE:
        return None
    return HealthFinding(
        check="sampler.fallback_storm",
        severity=CHECK_SEVERITIES["sampler.fallback_storm"],
        summary=(
            f"{fallbacks} sampler fallbacks over {finished} finished trials "
            f"({rate:.0%}): the configured sampler is effectively not running"
        ),
        evidence={"fallbacks": fallbacks, "finished_trials": finished, "rate": round(rate, 3)},
        remediation=(
            "the budget is being spent on independent/random sampling; check "
            "the sampler_fallback:* trial attrs for the failure, fix the "
            "history pathology or sampler config, or switch samplers"
        ),
    )


def _check_duplicate_proposals(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    from optuna_tpu_torch.trial._state import TrialState

    completed = [t for t in trials if t.state == TrialState.COMPLETE]
    seen: set[tuple] = set()
    duplicates = 0
    for t in completed:
        key = tuple(sorted((name, repr(value)) for name, value in t.params.items()))
        if key and key in seen:
            duplicates += 1
        else:
            seen.add(key)
    rate = duplicates / max(1, len(completed))
    if duplicates < DUPLICATE_MIN or rate < DUPLICATE_RATE:
        return None
    return HealthFinding(
        check="sampler.duplicate_proposals",
        severity=CHECK_SEVERITIES["sampler.duplicate_proposals"],
        summary=(
            f"{duplicates} of {len(completed)} completed trials repeat an "
            f"earlier parameter point exactly ({rate:.0%})"
        ),
        evidence={
            "duplicates": duplicates,
            "n_complete": len(completed),
            "rate": round(rate, 3),
        },
        remediation=(
            "duplicate proposals waste device evals: check for a collapsed "
            "search space (all-categorical / step-quantized), retry-clone "
            "storms, or a sampler stuck at its incumbent"
        ),
    )


def _check_quarantine_rate(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    quarantines = _counter_family_total(fleet["counters"], "executor.quarantine")
    reaps = _counter_family_total(fleet["counters"], "heartbeat.reap")
    finished = sum(1 for t in trials if t.state.is_finished())
    lost = quarantines + reaps
    rate = lost / max(1, finished)
    if lost < QUARANTINE_MIN or rate < QUARANTINE_RATE:
        return None
    return HealthFinding(
        check="executor.quarantine_rate",
        severity=CHECK_SEVERITIES["executor.quarantine_rate"],
        summary=(
            f"{quarantines} quarantined + {reaps} reaped of {finished} "
            f"finished trials ({rate:.0%} of the budget lost to containment)"
        ),
        evidence={
            "quarantines": quarantines,
            "reaps": reaps,
            "finished_trials": finished,
            "rate": round(rate, 3),
        },
        remediation=(
            "the containment layers are absorbing a systematic fault: check "
            "fail_reason trial attrs for the NaN source (objective or "
            "preprocessing), and worker stability if reaps dominate"
        ),
    )


def _check_dispatch_timeouts(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    strikes = _counter_family_total(fleet["counters"], "executor.dispatch_timeout")
    if strikes < DISPATCH_TIMEOUT_STRIKES:
        return None
    return HealthFinding(
        check="executor.dispatch_timeouts",
        severity=CHECK_SEVERITIES["executor.dispatch_timeouts"],
        summary=f"{strikes} dispatch-deadline strikes (each abandons a watchdog thread)",
        evidence={"strikes": strikes},
        remediation=(
            "dispatches are hanging: raise dispatch_deadline_s if the model "
            "is legitimately slow, otherwise look for a width-dependent "
            "deadlock in the objective (the flight trace shows which widths hung)"
        ),
    )


def _check_retrace_churn(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    retraces = sum(
        int(totals.get("retraces_after_first", 0))
        for totals in fleet.get("jit", {}).values()
    )
    if retraces < RETRACE_CHURN_MIN:
        return None
    labels = sorted(
        label
        for label, totals in fleet.get("jit", {}).items()
        if totals.get("retraces_after_first")
    )
    return HealthFinding(
        check="jit.retrace_churn",
        severity=CHECK_SEVERITIES["jit.retrace_churn"],
        summary=(
            f"{retraces} jit retraces after first compile "
            f"(labels: {', '.join(labels)})"
        ),
        evidence={"retraces_after_first": retraces, "labels": labels},
        remediation=(
            "steady-state retracing means a shape or static-arg keeps "
            "changing: pin batch widths to a fixed set (pad, don't vary) — "
            "the runtime face of graphlint TPU002"
        ),
    )


def _check_ladder_escalation(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    rung = fleet["gauges"].get("device.gp.ladder_rung.max")
    if rung is None or rung < LADDER_RUNG_WARN:
        return None
    return HealthFinding(
        check="gp.ladder_escalation",
        severity=CHECK_SEVERITIES["gp.ladder_escalation"],
        summary=(
            f"the Cholesky jitter ladder escalated to rung {int(rung)} "
            f"(>= {LADDER_RUNG_WARN}): Gram matrices are near-singular"
        ),
        evidence={"max_ladder_rung": rung},
        remediation=(
            "each rung is an extra on-device refactorization per fit: look "
            "for duplicated/clustered history rows (retry-clone storms) or a "
            "kernel length-scale collapsed by a degenerate objective"
        ),
    )


def _check_sparse_degraded(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    threshold = kw.get("sparse_heldout_err_warn", SPARSE_HELDOUT_ERR_WARN)
    err = fleet["gauges"].get("device.gp.sparse_heldout_err.last")
    if err is None or err < threshold:
        return None
    m = fleet["gauges"].get("device.gp.inducing_count.last")
    ratio = fleet["gauges"].get("device.gp.sparsity_ratio.last")
    return HealthFinding(
        check="gp.sparse_degraded",
        severity=CHECK_SEVERITIES["gp.sparse_degraded"],
        summary=(
            f"sparse GP held-out error {err:.2f} standardized units "
            f"(>= {threshold:g}): the inducing set no longer covers the search"
        ),
        evidence={
            "heldout_err": err,
            "inducing_count": m,
            "sparsity_ratio": ratio,
        },
        remediation=(
            "the SGPR approximation is starving: raise the inducing capacity "
            "(optimize_scan(n_inducing=...) / GPSampler(n_inducing=...)) or "
            "the exact-size threshold — the autopilot's gp.densify action "
            "does exactly this, one notch per firing"
        ),
    )


def _check_worker_dead(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    # Exited workers flushed a final snapshot on a clean loop exit: not
    # dead, however old that snapshot grows.
    dead = [w for w in fleet["workers"] if not w["alive"] and not w.get("exited")]
    if not dead:
        return None
    names = [w["worker"] for w in dead]
    return HealthFinding(
        check="worker.dead",
        severity=CHECK_SEVERITIES["worker.dead"],
        summary=(
            f"{len(dead)} of {fleet['n_workers']} workers stale past their "
            f"report interval: {', '.join(names)}"
        ),
        evidence={
            "dead_workers": names,
            "ages_s": {w["worker"]: w["age_s"] for w in dead},
            "n_workers": fleet["n_workers"],
        },
        remediation=(
            "a stale snapshot means the process died or wedged: its RUNNING "
            "trials are reapable by heartbeat failover; check the host, then "
            "re-launch the worker (retry clones re-enqueue its lost trials)"
        ),
    )


def _check_hub_dead(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    """A dead ``-serve`` worker is a dead suggestion *hub*: beyond the
    generic ``worker.dead`` story (reapable trials), its parked asks and
    ready queues are orphaned until the fleet router re-homes its studies —
    so the finding names the hub, the unit an operator restarts."""
    dead = [
        w
        for w in fleet["workers"]
        if w["worker"].endswith(HUB_WORKER_ID_SUFFIX)
        and not w["alive"]
        and not w.get("exited")
    ]
    if not dead:
        return None
    hubs = [w["worker"][: -len(HUB_WORKER_ID_SUFFIX)] for w in dead]
    return HealthFinding(
        check="service.hub_dead",
        severity=CHECK_SEVERITIES["service.hub_dead"],
        summary=(
            f"{len(hubs)} suggestion hub(s) stale past the liveness grace: "
            f"{', '.join(hubs)} — the fleet re-homes their studies to ring "
            f"successors"
        ),
        evidence={
            "dead_hubs": hubs,
            "ages_s": {
                w["worker"][: -len(HUB_WORKER_ID_SUFFIX)]: w["age_s"] for w in dead
            },
            "n_workers": fleet["n_workers"],
        },
        remediation=(
            "fleet clients redial the ring successor (op tokens dedupe "
            "re-sent asks through the shared replay records) and successors "
            "rebuild serve state from the shared journal; restart the hub "
            "process to restore capacity — on restart it resumes ownership "
            "automatically"
        ),
    )


def _check_shard_imbalance(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    """The sharded executor publishes per-shard throughput as
    ``shard.trials.t<k>.total`` gauges (one per trials-axis coordinate);
    a shard whose evaluated-trial count sits a factor below the mesh median
    is dragging the whole lockstep batch loop — SPMD waits for its slowest
    shard, so one cold chip taxes every trial."""
    prefix, suffix = "shard.trials.", ".total"
    counts: dict[str, float] = {}
    for name, value in fleet["gauges"].items():
        if name.startswith(prefix) and name.endswith(suffix):
            counts[name[len(prefix) : -len(suffix)]] = float(value)
    if len(counts) < 2:
        return None
    import statistics

    # Evidence floor on the BEST shard, not the median: with a majority of
    # shards dead (the worst imbalance case) the median itself is ~0, and
    # a median-gated check would go silent exactly when it matters most.
    if max(counts.values()) < SHARD_IMBALANCE_MIN_TRIALS:
        return None  # too little evidence: startup skew is not imbalance
    median = statistics.median(counts.values())
    lagging = {
        coord: count
        for coord, count in counts.items()
        if count * SHARD_IMBALANCE_FACTOR <= median
    }
    if not lagging:
        return None
    return HealthFinding(
        check="shard.imbalance",
        severity=CHECK_SEVERITIES["shard.imbalance"],
        summary=(
            f"{len(lagging)} of {len(counts)} trial shards at >= "
            f"{SHARD_IMBALANCE_FACTOR:g}x below the mesh median throughput "
            f"({median:g} trials): {', '.join(sorted(lagging))}"
        ),
        evidence={
            "shard_trials": {k: counts[k] for k in sorted(counts)},
            "median": median,
            "lagging_shards": sorted(lagging),
        },
        remediation=(
            "SPMD runs at the slowest shard's pace: check the lagging "
            "coordinate's host/chip (thermal throttling, a contended "
            "tunnel), and whether its slots absorb the quarantines "
            "(fail_reason attrs say which trials they were)"
        ),
    )


def _check_backpressure(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    counters = fleet["counters"]
    sheds = {
        name[len("serve.shed."):]: value
        for name, value in counters.items()
        if name.startswith("serve.shed.")
    }
    total = sum(sheds.values())
    if total < BACKPRESSURE_SHED_MIN:
        return None
    return HealthFinding(
        check="service.backpressure",
        severity=CHECK_SEVERITIES["service.backpressure"],
        summary=(
            f"the suggestion service shed {total} asks "
            f"({', '.join(f'{k}: {sheds[k]}' for k in sorted(sheds))}): "
            "the overload ladder is engaged"
        ),
        evidence={"sheds": {k: sheds[k] for k in sorted(sheds)}, "total": total},
        remediation=(
            "clients are arriving faster than the server can propose: raise "
            "max_coalesce / ready_ahead on the service, add a second hub, or "
            "slow the client ask rate; rejected clients honor retry-after, "
            "so convergence is delayed, not lost"
        ),
    )


def _check_ready_queue_starved(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    counters = fleet["counters"]
    hits = counters.get("serve.ready_queue.hit", 0)
    misses = counters.get("serve.ready_queue.miss", 0)
    lookups = hits + misses
    rate = misses / max(1, lookups)
    if misses < READY_QUEUE_MISS_MIN or rate < READY_QUEUE_MISS_RATE:
        return None
    return HealthFinding(
        check="service.ready_queue_starved",
        severity=CHECK_SEVERITIES["service.ready_queue_starved"],
        summary=(
            f"{misses} of {lookups} asks missed the speculative ready queue "
            f"({rate:.0%}): steady-state asks are paying full fit+propose latency"
        ),
        evidence={
            "hits": hits,
            "misses": misses,
            "rate": round(rate, 3),
            "refills": counters.get("serve.ready_queue.refill", 0),
            "invalidations": counters.get("serve.ready_queue.invalidate", 0),
        },
        remediation=(
            "the ask-ahead worker is not keeping up: raise ready_ahead, relax "
            "invalidate_after (each invalidation stales a whole queue), or "
            "check whether refill dispatches are starved of device time"
        ),
    )


def _check_slo_burn(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    """The SLO engine's verdicts through the fleet channel: a spec some
    worker reports as *burning* (the two-window AND evaluated per worker,
    merged by OR) with the fleet-wide violation floor met. Severity
    escalates with the burn rate (the one check whose severity is not
    fixed): WARNING at a sustainable-rate leak, CRITICAL once some worker's
    windows cross ``BURN_CRITICAL`` (budget gone in window/6 — the
    fast-burn page). Legacy snapshots without the per-worker booleans fall
    back to re-deriving the AND from the (then single-worker) windows."""
    from optuna_tpu_torch import slo as slo_module

    burning: dict[str, dict[str, Any]] = {}
    any_critical = False
    for spec_id, entry in (fleet.get("slo") or {}).items():
        bad = int(entry.get("bad", 0))
        burn_long = float(entry.get("burn_long", 0.0))
        burn_short = float(entry.get("burn_short", 0.0))
        if bad < kw.get("slo_burn_min_violations", SLO_BURN_MIN_VIOLATIONS):
            continue
        is_burning = entry.get("burning")
        if is_burning is None:  # pre-verdict snapshot shape
            is_burning = (
                burn_long >= slo_module.BURN_WARN
                and burn_short >= slo_module.BURN_WARN
            )
        if not is_burning:
            continue
        burning[spec_id] = {
            "good": int(entry.get("good", 0)),
            "bad": bad,
            "burn_long": burn_long,
            "burn_short": burn_short,
            "target_s": entry.get("target_s"),
            "objective": entry.get("objective"),
        }
        is_critical = entry.get("critical")
        if is_critical is None:
            is_critical = (
                burn_long >= slo_module.BURN_CRITICAL
                and burn_short >= slo_module.BURN_CRITICAL
            )
        if is_critical:
            any_critical = True
    if not burning:
        return None
    worst = max(burning.items(), key=lambda kv: kv[1]["burn_long"])
    return HealthFinding(
        check="service.slo_burn",
        severity="CRITICAL" if any_critical else "WARNING",
        summary=(
            f"{len(burning)} SLO(s) burning error budget, worst "
            f"{worst[0]} at {worst[1]['burn_long']:g}x long-window / "
            f"{worst[1]['burn_short']:g}x short-window burn"
        ),
        evidence={"slos": {k: burning[k] for k in sorted(burning)}},
        remediation=(
            "the system is violating its own latency objectives while budget "
            "remains: shed earlier (the ShedPolicy SLO feed already halves "
            "thresholds), add serving capacity (max_coalesce/ready_ahead or a "
            "second hub), or re-negotiate the target in slo.DEFAULT_SLOS — "
            "`optuna-tpu slo` shows the live quantiles per phase"
        ),
    )


def _check_checkpoint_stale(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    counters = fleet["counters"]
    rejected = _counter_family_total(counters, "checkpoint.rejected")
    stale = _counter_family_total(counters, "checkpoint.stale")
    fallbacks = counters.get("checkpoint.fallback", 0)
    total = rejected + stale
    if total < kw.get("checkpoint_reject_min", CHECKPOINT_REJECT_MIN):
        return None
    return HealthFinding(
        check="checkpoint.stale",
        severity=CHECK_SEVERITIES["checkpoint.stale"],
        summary=(
            f"{total} checkpoint blob(s) were rejected at restore "
            f"({rejected} corrupt/torn/version-drifted, {stale} watermark-stale); "
            f"{fallbacks} resume(s) fell back to a full recompute from history"
        ),
        evidence={
            "rejected": rejected,
            "stale": stale,
            "fallbacks": fallbacks,
            "writes": counters.get("checkpoint.write", 0),
            "write_errors": counters.get("checkpoint.write_error", 0),
            "restores": counters.get("checkpoint.restore", 0),
        },
        remediation=(
            "resumes still complete (recompute-from-COMPLETE-history is the "
            "fallback) but pay the full refit at every preemption: check the "
            "storage for torn attr writes, whether writers and resumers run "
            "the same CHECKPOINT_SCHEMA_VERSION, and whether checkpoints are "
            "written often enough that their watermark keeps up with the "
            "synced history"
        ),
    )


def _lease_history(fleet: dict) -> list[dict]:
    lease = fleet.get("lease") or {}
    return [h for h in lease.get("history", ()) if isinstance(h, Mapping)]


def _check_hub_flapping(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    """Takeovers are normal one at a time — a failover, then maybe a
    failback. Several inside one window mean study ownership is
    *oscillating*: two hubs keep declaring each other dead (asymmetric
    partition, clock skew, a liveness TTL tighter than the real RTT), and
    every bounce pays a warm-load plus a fence-demotion round trip. The
    window anchors on the newest takeover, not wall-clock now, so an old
    resolved flap ages out of the report identically everywhere."""
    history = _lease_history(fleet)
    takeovers = [h for h in history if int(h.get("epoch", 0)) > 1]
    if not takeovers:
        return None
    window = kw.get("hub_flap_window_s", HUB_FLAP_WINDOW_S)
    ref = max(float(h.get("unix", 0.0)) for h in takeovers)
    recent = [h for h in takeovers if ref - float(h.get("unix", 0.0)) <= window]
    if len(recent) < kw.get("hub_flap_min_takeovers", HUB_FLAP_MIN_TAKEOVERS):
        return None
    lease = fleet.get("lease") or {}
    hubs = sorted({str(h.get("owner")) for h in recent})
    return HealthFinding(
        check="service.hub_flapping",
        severity=CHECK_SEVERITIES["service.hub_flapping"],
        summary=(
            f"study ownership changed hands {len(recent)} times inside "
            f"{window:g}s across hubs {', '.join(hubs)} (lease epoch now "
            f"{int(lease.get('epoch', 0))})"
        ),
        evidence={
            "takeovers_in_window": len(recent),
            "window_s": window,
            "hubs": hubs,
            "owner": lease.get("owner"),
            "epoch": int(lease.get("epoch", 0)),
        },
        remediation=(
            "repeated takeovers mean the hubs disagree about liveness: check "
            "for an asymmetric partition between them, raise the lease TTL / "
            "liveness grace above the real inter-hub RTT, and verify the "
            "hubs' clocks — each bounce costs a warm-load and a fenced "
            "demotion, so the flap itself is burning serve latency"
        ),
    )


def _check_hub_zombie_fenced(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    """``fleet.fenced_write`` only ever counts a *rejected* stale-epoch
    write: a hub the fleet deposed is still running and still trying to
    write serve state. The fence held (nothing reached the journal), but a
    zombie that keeps writing is a partitioned process an operator should
    find and stop — it is also still burning accelerator time on a study
    it no longer owns."""
    fenced = int(fleet["counters"].get("fleet.fenced_write", 0))
    if fenced <= 0:
        return None
    lease = fleet.get("lease") or {}
    demotions = int(fleet["counters"].get("fleet.lease.demote", 0))
    return HealthFinding(
        check="service.hub_zombie_fenced",
        severity=CHECK_SEVERITIES["service.hub_zombie_fenced"],
        summary=(
            f"{fenced} stale-epoch serve-state write(s) were fenced "
            f"(StaleLeaseError) — a deposed hub kept writing; current owner "
            f"{lease.get('owner')!r} at epoch {int(lease.get('epoch', 0))}"
        ),
        evidence={
            "fenced_writes": fenced,
            "demotions": demotions,
            "owner": lease.get("owner"),
            "epoch": int(lease.get("epoch", 0)),
        },
        remediation=(
            "the journal is safe — every counted write was rejected — but a "
            "zombie hub is live behind a partition: find the deposed process "
            "(the lease history names past owners), confirm it self-demoted "
            "(fleet.lease.demote) and is redialing clients to the successor, "
            "then heal the partition or retire the process"
        ),
    )


def _check_partition_suspected(
    fleet: dict, trials: Sequence["FrozenTrial"], directions, **kw
) -> HealthFinding | None:
    """The latest lease takeover displaced a hub whose ``-serve`` snapshot
    is still *fresh*: a crashed hub goes stale (that is ``service.hub_dead``'s
    story), so a live deposed hub means the fleet split-brained — partition,
    not crash. A recent intentional restart-and-failback also matches (the
    reclaimed-from successor is alive by design); the finding is a WARNING
    pointing at the disagreement, not a page."""
    history = _lease_history(fleet)
    if len(history) < 2:
        return None
    latest, prev = history[-1], history[-2]
    if int(latest.get("epoch", 0)) <= 1:
        return None
    deposed = str(prev.get("owner"))
    if deposed == str(latest.get("owner")):
        return None
    snapshot = next(
        (
            w
            for w in fleet["workers"]
            if w["worker"] == deposed + HUB_WORKER_ID_SUFFIX
        ),
        None,
    )
    if snapshot is None or not snapshot["alive"]:
        return None  # stale or absent: a crash, service.hub_dead's story
    return HealthFinding(
        check="service.partition_suspected",
        severity=CHECK_SEVERITIES["service.partition_suspected"],
        summary=(
            f"hub {latest.get('owner')!r} took the study lease (epoch "
            f"{int(latest.get('epoch', 0))}) from {deposed!r}, whose -serve "
            f"snapshot is still fresh ({snapshot['age_s']:g}s old): the "
            f"deposed hub is alive — partition suspected, not a crash"
        ),
        evidence={
            "owner": latest.get("owner"),
            "epoch": int(latest.get("epoch", 0)),
            "deposed": deposed,
            "deposed_age_s": snapshot["age_s"],
        },
        remediation=(
            "both hubs are running but disagreed about liveness: check "
            "connectivity between them (one-way partitions produce exactly "
            "this), confirm the deposed hub self-demoted rather than serving "
            "stale state (its writes would land as fleet.fenced_write), and "
            "expect a failback takeover when the partition heals; if this was "
            "an intentional restart, no action is needed"
        ),
    )


#: The rule table: one function per check id, keyed exactly by
#: :data:`HEALTH_CHECKS` (asserted by ``tests/test_torch_health.py`` — a check in
#: the vocabulary without a rule, or vice versa, is a test failure).
_CHECK_FUNCS: dict[str, Callable[..., HealthFinding | None]] = {
    "study.stagnation": _check_stagnation,
    "sampler.fallback_storm": _check_fallback_storm,
    "sampler.duplicate_proposals": _check_duplicate_proposals,
    "executor.quarantine_rate": _check_quarantine_rate,
    "executor.dispatch_timeouts": _check_dispatch_timeouts,
    "jit.retrace_churn": _check_retrace_churn,
    "gp.ladder_escalation": _check_ladder_escalation,
    "gp.sparse_degraded": _check_sparse_degraded,
    "worker.dead": _check_worker_dead,
    "shard.imbalance": _check_shard_imbalance,
    "service.backpressure": _check_backpressure,
    "service.ready_queue_starved": _check_ready_queue_starved,
    "service.slo_burn": _check_slo_burn,
    "service.hub_dead": _check_hub_dead,
    "checkpoint.stale": _check_checkpoint_stale,
    "service.hub_flapping": _check_hub_flapping,
    "service.hub_zombie_fenced": _check_hub_zombie_fenced,
    "service.partition_suspected": _check_partition_suspected,
}

_SEVERITY_ORDER = {name: i for i, name in enumerate(SEVERITIES)}


def diagnose(
    fleet: dict,
    trials: Sequence["FrozenTrial"],
    directions: Sequence["StudyDirection"],
    *,
    checks: Sequence[str] | None = None,
    **overrides: Any,
) -> list[HealthFinding]:
    """Run the registered checks over a fleet snapshot + trial history and
    return the findings, most severe first (ties keep check-table order).
    ``checks`` restricts the run to a subset of ids (the hot path's warn
    pass evaluates only the CRITICAL-capable ones); ``overrides`` are
    threshold keyword overrides individual checks accept (currently
    ``stagnation_window``)."""
    findings = []
    for check, fn in _CHECK_FUNCS.items():
        if checks is not None and check not in checks:
            continue
        finding = fn(fleet, trials, directions, **overrides)
        if finding is not None:
            assert finding.check == check
            findings.append(finding)
    findings.sort(key=lambda f: -_SEVERITY_ORDER[f.severity])
    return findings


# ----------------------------------------------------------------- report


def health_report(
    storage: "BaseStorage",
    study_id: int,
    *,
    study_name: str | None = None,
    now: float | None = None,
    **overrides: Any,
) -> dict[str, Any]:
    """The doctor's full report for one study: fleet snapshot + liveness +
    findings, as one JSON-able dict. This is the single implementation every
    surface serves — ``Study.health_report()``, ``optuna-tpu-torch doctor`` and
    ``/health.json`` all return exactly this shape."""
    now = time.time() if now is None else now
    if study_name is None:
        study_name = storage.get_study_name_from_id(study_id)
    fleet = fleet_snapshot(storage, study_id, now=now)
    trials = storage.get_all_trials(study_id, deepcopy=False)
    directions = storage.get_study_directions(study_id)
    findings = diagnose(fleet, trials, directions, **overrides)
    from optuna_tpu_torch.trial._state import TrialState

    return {
        "study": study_name,
        "generated_unix": now,
        "n_trials": len(trials),
        "n_complete": sum(1 for t in trials if t.state == TrialState.COMPLETE),
        "n_failed": sum(1 for t in trials if t.state == TrialState.FAIL),
        "n_running": sum(1 for t in trials if t.state == TrialState.RUNNING),
        "checks_evaluated": sorted(HEALTH_CHECKS),
        "workers": fleet["workers"],
        "fleet": {
            "counters": fleet["counters"],
            "gauges": fleet["gauges"],
            "histograms": fleet["histograms"],
            "jit": fleet["jit"],
            "slo": fleet.get("slo", {}),
        },
        "findings": [f.to_dict() for f in findings],
        "healthy": not findings,
    }


def report_for_study(study: "Study", **kwargs: Any) -> dict[str, Any]:
    """:func:`health_report` over a live :class:`Study` object."""
    return health_report(
        study._storage, study._study_id, study_name=study.study_name, **kwargs
    )


def storage_health_reports(
    storage: "BaseStorage", *, now: float | None = None
) -> dict[str, Any]:
    """Reports for every study in a storage — the ``/health.json`` payload a
    process that owns the storage serves beside ``/metrics``
    (``telemetry.serve_metrics(port, health_source=...)``): it is the one
    process that can see the whole fleet."""
    now = time.time() if now is None else now
    reports = []
    for frozen in storage.get_all_studies():
        reports.append(
            health_report(
                storage, frozen._study_id, study_name=frozen.study_name, now=now
            )
        )
    # ``enabled`` distinguishes an armed doctor (this payload) from the
    # structured not-armed payload a source-less metrics server serves for
    # /health.json — the /slo.json contract, so a scraper can always tell
    # "no doctor wired" from "fleet healthy" from "typo'd path".
    return {"enabled": True, "generated_unix": now, "reports": reports}


def render_text(
    report: Mapping[str, Any], *, would_act: Mapping[str, str] | None = None
) -> str:
    """The ``optuna-tpu-torch doctor`` table rendering of one report: verdict
    line, worker liveness, fleet containment counters, then one block per
    finding with evidence and remediation. ``would_act`` maps check ids to
    autopilot action ids — when an autopilot policy is configured the CLI
    passes :data:`optuna_tpu_torch.autopilot.ACTION_TRIGGERS`' reverse map, and
    each actionable finding gains a "would act" line."""
    lines: list[str] = []
    verdict = "HEALTHY" if report["healthy"] else (
        f"{len(report['findings'])} finding(s)"
    )
    lines.append(
        f"study {report['study']!r}: {verdict} — "
        f"{report['n_complete']} complete / {report['n_failed']} failed / "
        f"{report['n_running']} running of {report['n_trials']} trials"
    )
    workers = report.get("workers", ())
    if workers:
        lines.append("workers:")
        for w in workers:
            if w.get("exited"):
                state = "exited"  # clean terminal flush: done, not dead
            else:
                state = "alive" if w["alive"] else "DEAD"
            lines.append(
                f"  {w['worker']}: {state} (last seen {w['age_s']:.1f}s ago, "
                f"interval {w['interval_s']}s, seq {w.get('seq')})"
            )
    else:
        lines.append(
            "workers: none reported (enable the reporter with "
            "OPTUNA_TPU_TORCH_HEALTH=1 on the workers)"
        )
    counters = report.get("fleet", {}).get("counters", {})
    if counters:
        lines.append("fleet counters:")
        for name in sorted(counters):
            lines.append(f"  {name}: {counters[name]}")
    for finding in report["findings"]:
        lines.append(f"[{finding['severity']}] {finding['check']}: {finding['summary']}")
        for key in sorted(finding["evidence"]):
            lines.append(f"    {key}: {finding['evidence'][key]}")
        if finding["remediation"]:
            lines.append(f"    -> {finding['remediation']}")
        if would_act is not None:
            action = would_act.get(finding["check"])
            lines.append(
                f"    would act: {action}"
                if action
                else "    would act: (no autopilot action for this check)"
            )
    return "\n".join(lines)


# The environment switch mirrors telemetry's/flight's: set before import,
# reporting is armed from trial zero.
if _env_enabled():
    interval_raw = os.environ.get("OPTUNA_TPU_TORCH_HEALTH_INTERVAL_S", "").strip()
    try:
        enable(interval_s=float(interval_raw) if interval_raw else None)
    except ValueError:
        enable()
