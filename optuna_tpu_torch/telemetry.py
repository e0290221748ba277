"""Telemetry: host-side metrics for the study loop and its containment (port
of ``optuna_tpu/telemetry.py``; standard library only).

* :class:`MetricsRegistry` — counters, gauges, and monotonic-clock
  histograms with fixed log-spaced buckets; the clock is injectable so
  tests assert timings without real waiting.
* ``span(name)`` — a context manager timing one phase of the study loop
  into the ``phase.<name>`` histogram. Phase names come from the
  :data:`PHASES` vocabulary; :func:`trace_name` gives the same phase's
  ``torch.profiler`` range name (:mod:`optuna_tpu_torch._tracing`), so
  profiler timelines and metrics histograms line up one-to-one.
* ``count(name)`` — containment counters (:data:`COUNTERS` vocabulary).
* Exports — :func:`snapshot` and :func:`export_snapshot` (JSON-able dicts,
  the latter also ``Study.telemetry_snapshot()``), :func:`render_prometheus`
  (text exposition format, the reference's metric names byte for byte,
  served by :func:`serve_metrics`), and the ``optuna-tpu-torch metrics``
  CLI dump.

Telemetry is **off** by default, and the disabled hot path is module-global
checks only: ``count`` returns immediately (after offering the event to the
flight recorder's sink when one is hooked) and ``span`` returns a shared
singleton null context, so a disabled study loop allocates nothing per
trial on this module's account. Instrumentation is strictly host-side and
never reads a device value. Enable with ``OPTUNA_TPU_TORCH_TELEMETRY=1`` in
the environment, or :func:`enable` / :func:`disable` at runtime.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Iterator, Mapping

from optuna_tpu_torch import locksan

__all__ = [
    "BUCKET_BOUNDS",
    "COUNTERS",
    "HistogramState",
    "PHASES",
    "MetricsRegistry",
    "add_gauge",
    "count",
    "disable",
    "enable",
    "enabled",
    "export_snapshot",
    "get_registry",
    "histogram_quantile",
    "max_gauge",
    "observe",
    "observe_phase",
    "phase_totals",
    "render_prometheus",
    "reset",
    "serve_metrics",
    "set_gauge",
    "snapshot",
    "span",
    "trace_name",
]


# ------------------------------------------------------------- vocabulary

#: The study-loop phase vocabulary: every ``span()`` name draws from it,
#: spelled ``phase.<phase>`` in metrics and ``optuna_tpu_torch.<phase>`` on
#: the profiler timeline. The names are the reference's.
PHASES: dict[str, str] = {
    "ask": "trial creation + parameter suggestion (Study.ask / ask_batch)",
    "ask.search_space": "relative search-space construction inside the sampler",
    "ask.fit": "surrogate fit inputs + fitting (host packing, GP/TPE fit)",
    "ask.propose": "acquisition optimization / fused proposal dispatch",
    "dispatch": "objective execution (serial call or batched device dispatch)",
    "tell": "result commit + callbacks (study.tell / batch tell loop)",
    "storage.op": "one logical storage operation (retries + backoff included)",
    "scan.chunk": "one device-resident scan chunk: fit, factorization and its ask/evaluate/tell steps",
    "scan.sync": "chunk-boundary result read-back + storage sync of a scan chunk's trials",
    "shard.exchange": "one pod-wide ICI-journal exchange point at a sharded batch boundary",
    "serve.ask": "one suggestion-service ask served end to end (queue pop, shed rung, or coalesced dispatch)",
    "serve.coalesce": "one fused proposal dispatch answering a whole coalesced ask batch",
    "serve.ready_queue": "one speculative ask-ahead refill dispatch (background, off the RPC path)",
    "ckpt.write": "one best-effort durable checkpoint write at a loop boundary (encode + attr write)",
    "ckpt.restore": "one resume's checkpoint validation + carry reconstruction (load, verify, rebuild)",
}

#: The containment-counter vocabulary: one entry per event family the
#: resilience layers can fire. Families marked ``(suffixed)`` append a
#: sub-family at the call site (e.g. ``sampler.fallback.relative``). The
#: names are the reference's.
COUNTERS: dict[str, str] = {
    "storage.retry": "RetryPolicy replayed a transiently-failed call",
    "grpc.redial": "gRPC client dropped a wedged channel and dialed fresh",
    "grpc.op_token_dedup": "gRPC server deduped a replayed replay-unsafe write",
    "sampler.fallback": "(suffixed by phase) a suggestion degraded to the independent path",
    "executor.quarantine": "a non-finite trial was quarantined as FAIL",
    "executor.bisection": "a failed dispatch was bisected to isolate poison trials",
    "executor.oom_halving": "an OOM-shaped dispatch error halved the batch",
    "executor.dispatch_timeout": "a device dispatch overran its deadline and was abandoned",
    "heartbeat.reap": "a stale (dead-worker) RUNNING trial was reaped to FAIL",
    "journal.lock_contention": "a journal lock acquire found the lock held and backed off",
    "serve.shed": "(suffixed by policy) an overloaded ask was degraded or refused by the shed ladder",
    "serve.ready_queue": "(suffixed hit|miss|refill|invalidate) a speculative ready-queue event on the suggestion service",
    "autopilot.action": "(suffixed by action id, or 'rollback'/'held') the autopilot decided a guarded remediation (observe logs it, act executes it)",
    "serve.fleet": "(suffixed by fleet event) a hub-fleet routing decision: forward, replay, re-home, or a declared hub death",
    "fleet.lease": "(suffixed by lease event) a study-ownership lease transition: acquire, renew, takeover, or a fence-tripped hub's self-demotion",
    "fleet.fenced_write": "a stale-epoch serve-state write from a zombie hub was rejected by the lease fence (StaleLeaseError)",
    "grpc.op_token_evicted_live": "an op-token dedupe entry younger than the client retry window was evicted (server LRU or fleet replay ring): a delayed duplicate would re-execute",
    "locksan.verdict": "(suffixed by kind) the lock sanitizer reported a potential deadlock cycle or a blocking window under held locks",
    "checkpoint": "(suffixed by checkpoint event) a durable-checkpoint lifecycle event: write, rejection, restore, fallback, or warm load",
    "journal.snapshot_rejected": "a journal snapshot failed its CRC/unpickle validation and was replaced by a full log replay",
}

_PHASE_METRIC_PREFIX = "phase."
_TRACE_PREFIX = "optuna_tpu_torch."


def trace_name(phase: str) -> str:
    """The ``torch.profiler.record_function`` name for a :data:`PHASES`
    entry (``optuna_tpu_torch.scan.chunk`` for ``scan.chunk``)."""
    return _TRACE_PREFIX + phase


# ------------------------------------------------------------ histograms

#: Fixed log-spaced latency buckets (seconds): half-decade steps from 10 µs
#: to ~100 s, the span between one served ready-queue pop and a
#: hung-dispatch deadline. The bottom decade (10 µs / ~32 µs) exists for the
#: suggestion service's serve path — a ~1 ms ask and a ~50 µs queue pop must
#: not floor into one bucket. Fixed (not configurable per histogram) so
#: every phase histogram is cross-comparable and the Prometheus series set
#: stays bounded.
BUCKET_BOUNDS: tuple[float, ...] = tuple(10.0 ** (k / 2.0) for k in range(-10, 5))


class HistogramState:
    """One histogram's live state: total count/sum plus raw per-bucket
    counts over the fixed :data:`BUCKET_BOUNDS` ladder (+Inf tail last)."""

    __slots__ = ("count", "total", "bucket_counts")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.bucket_counts = [0] * (len(BUCKET_BOUNDS) + 1)  # +inf tail

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        for i, bound in enumerate(BUCKET_BOUNDS):
            if value <= bound:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (Prometheus ``histogram_quantile``
        semantics): locate the bucket where the cumulative count crosses
        ``q * count`` and interpolate linearly inside it (the lowest bucket
        interpolates from 0; observations in the +Inf tail answer with the
        last finite bound — the histogram cannot resolve past it). An
        *approximation* bounded by bucket width; the SLO engine's P² sketch
        is the precise streaming estimator — this helper is for snapshots
        and fleet merges, where only bucket counts survive."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]; got {q}.")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cumulative = 0
        for i, bound in enumerate(BUCKET_BOUNDS):
            in_bucket = self.bucket_counts[i]
            if in_bucket and cumulative + in_bucket >= rank:
                lower = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                fraction = (rank - cumulative) / in_bucket
                return lower + (bound - lower) * max(0.0, min(1.0, fraction))
            cumulative += in_bucket
        return BUCKET_BOUNDS[-1]



def histogram_quantile(hist: Mapping, q: float) -> float:
    """:meth:`HistogramState.quantile` over a *snapshot-shaped* histogram
    dict (``{"count", "sum", "buckets": {bound_label: raw count}}``) — the
    form ``/metrics.json`` consumers and the doctor's fleet merges hold.
    Bucket labels parse back through :func:`_format_bound`'s rendering
    (``"+Inf"`` for the tail)."""
    state = HistogramState()
    buckets = hist.get("buckets", {}) if isinstance(hist, Mapping) else {}
    by_bound = {}
    for label, count in buckets.items():
        by_bound[float("inf") if label == "+Inf" else float(label)] = int(count)
    for i, bound in enumerate(BUCKET_BOUNDS):
        # Snapshot labels render via _format_bound; match through the same
        # formatter so float re-parsing cannot drift.
        state.bucket_counts[i] = by_bound.get(float(_format_bound(bound)), 0)
    state.bucket_counts[-1] = by_bound.get(float("inf"), 0)
    state.count = sum(state.bucket_counts)
    return state.quantile(q)


class _Span:
    """Times one ``with`` block into the registry's phase histogram."""

    __slots__ = ("_registry", "_name", "_start")

    def __init__(self, registry: "MetricsRegistry", name: str) -> None:
        self._registry = registry
        self._name = name

    def __enter__(self) -> "_Span":
        self._start = self._registry._clock()
        return self

    def __exit__(self, *exc: object) -> None:
        self._registry.observe(self._name, self._registry._clock() - self._start)


class _NullSpan:
    """The disabled-path span: one shared instance, allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None


_NULL_SPAN = _NullSpan()


# -------------------------------------------------------------- registry


class MetricsRegistry:
    """Thread-safe counters + gauges + fixed-bucket latency histograms.

    Standard library only. ``clock`` is injectable for deterministic span
    tests; it must be monotonic (wall clocks jump under NTP).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = locksan.lock("telemetry.registry")
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, HistogramState] = {}

    # ------------------------------------------------------------- write

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def add_gauge(self, name: str, delta: float) -> None:
        """Accumulate into a gauge atomically (read-modify-write under the
        registry lock): the device-stats harvest publishes per-dispatch
        totals from concurrent threads, where a caller-side ``set_gauge(read
        + delta)`` would lose updates."""
        with self._lock:
            self._gauges[name] = self._gauges.get(name, 0.0) + float(delta)

    def max_gauge(self, name: str, value: float) -> None:
        """Raise a gauge to ``value`` if larger, atomically — high-water
        marks (max ladder rung, device memory peak) under concurrent harvesters."""
        with self._lock:
            current = self._gauges.get(name)
            if current is None or value > current:
                self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = HistogramState()
            hist.observe(value)

    def span(self, name: str) -> _Span:
        """Time a ``with`` block into the ``phase.<name>`` histogram."""
        return _Span(self, _PHASE_METRIC_PREFIX + name)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # -------------------------------------------------------------- read

    def counter_value(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        """One JSON-able dict of everything recorded so far. Bucket keys are
        the stringified upper bounds (``"+Inf"`` for the tail), with raw
        (non-cumulative) per-bucket counts."""
        with self._lock:
            histograms = {}
            for name, hist in self._histograms.items():
                buckets = {
                    _format_bound(bound): hist.bucket_counts[i]
                    for i, bound in enumerate(BUCKET_BOUNDS)
                }
                buckets["+Inf"] = hist.bucket_counts[-1]
                histograms[name] = {
                    "count": hist.count,
                    "sum": hist.total,
                    "buckets": buckets,
                }
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": histograms,
            }

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4): metric names are
        sanitized (non-``[a-zA-Z0-9_]`` -> underscores) under the
        ``optuna_tpu_`` namespace (the reference's names, so one scrape config
    reads both packages); histogram buckets are cumulative with the
        conventional ``le`` label. **Dynamic-suffix families** — counters
        like ``sampler.fallback.<family>`` and the per-label jit gauges —
        render the suffix as an escaped *label* instead of flattening it
        into the metric name: the suffix is open vocabulary (a sampler
        phase, a user-chosen jit label) and flattening it would mint one
        metric name per value, break aggregation across the family, and let
        an unsanitized character corrupt the exposition."""
        lines: list[str] = []
        snap = self.snapshot()
        emitted_types: set[str] = set()

        def emit(metric: str, kind: str, labels: str, value: str) -> None:
            if metric not in emitted_types:
                emitted_types.add(metric)
                lines.append(f"# TYPE {metric} {kind}")
            lines.append(f"{metric}{labels} {value}")

        for name, value in sorted(snap["counters"].items()):
            family = _split_labeled(name, _LABELED_COUNTER_FAMILIES)
            if family is not None:
                base, label_name, label_value = family
                emit(
                    _prom_name(base) + "_total", "counter",
                    _render_labels({label_name: label_value}), str(value),
                )
            else:
                emit(_prom_name(name) + "_total", "counter", "", str(value))
        for name, value in sorted(snap["gauges"].items()):
            family = _split_labeled(name, _LABELED_GAUGE_FAMILIES)
            if family is not None:
                base, label_name, label_value = family
                emit(
                    _prom_name(base), "gauge",
                    _render_labels({label_name: label_value}),
                    _format_value(value),
                )
            else:
                emit(_prom_name(name), "gauge", "", _format_value(value))
        for name, hist in sorted(snap["histograms"].items()):
            metric = _prom_name(name) + "_seconds"
            lines.append(f"# TYPE {metric} histogram")
            cumulative = 0
            for bound_label, bucket_count in hist["buckets"].items():
                cumulative += bucket_count
                lines.append(f'{metric}_bucket{{le="{bound_label}"}} {cumulative}')
            lines.append(f"{metric}_sum {_format_value(hist['sum'])}")
            lines.append(f"{metric}_count {hist['count']}")
        return "\n".join(lines) + "\n"


def _format_bound(bound: float) -> str:
    return f"{bound:.6g}"


def _format_value(value: float) -> str:
    return f"{value:.9g}"


def _prom_name(name: str) -> str:
    # Explicitly ASCII: str.isalnum() admits any Unicode letter/digit, which
    # the exposition grammar ([a-zA-Z0-9_:]) does not — a gauge named with a
    # non-ASCII character must sanitize, not corrupt the scrape.
    cleaned = "".join(
        c if (c.isascii() and c.isalnum()) else "_" for c in name
    )
    return "optuna_tpu_" + cleaned


#: Metric families whose trailing segment is open vocabulary and therefore
#: renders as a label, as ``{family prefix: label name}``. The counter side
#: is exactly the ``(suffixed)`` families in :data:`COUNTERS`; the gauge
#: side is the per-label jit instrumentation from :mod:`optuna_tpu_torch.flight`.
_LABELED_COUNTER_FAMILIES: dict[str, str] = {
    "sampler.fallback": "family",
    "serve.shed": "policy",
    "serve.ready_queue": "event",
    "serve.fleet": "event",
    "locksan.verdict": "kind",
}
_LABELED_GAUGE_FAMILIES: dict[str, str] = {
    "jit.compiles": "label",
    "jit.compile_seconds": "label",
    "jit.retraces_after_first": "label",
}


def _split_labeled(
    name: str, families: Mapping[str, str]
) -> tuple[str, str, str] | None:
    """``(family, label name, label value)`` when ``name`` extends a labeled
    family (``sampler.fallback.relative`` -> ``("sampler.fallback",
    "family", "relative")``); None for everything else, including the bare
    family name (which renders unlabeled — a legal series of the same
    metric)."""
    for family, label_name in families.items():
        if name.startswith(family + ".") and len(name) > len(family) + 1:
            return family, label_name, name[len(family) + 1:]
    return None


def _escape_label_value(value: str) -> str:
    """Exposition-format label-value escaping: backslash, double-quote and
    newline are the three characters the grammar reserves."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _render_labels(labels: Mapping[str, str]) -> str:
    inner = ",".join(
        f'{_prom_label_name(k)}="{_escape_label_value(str(v))}"'
        for k, v in labels.items()
    )
    return "{" + inner + "}"


def _prom_label_name(name: str) -> str:
    cleaned = "".join(
        c if (c.isascii() and c.isalnum()) else "_" for c in name
    )
    # Label names may not start with a digit (metric names dodge this via
    # the optuna_tpu_ prefix; labels have no such shield).
    return ("_" + cleaned) if cleaned[:1].isdigit() else (cleaned or "_")


# ------------------------------------------------- module-level fast path

_REGISTRY = MetricsRegistry()
_enabled = bool(os.environ.get("OPTUNA_TPU_TORCH_TELEMETRY"))

#: Optional event sink the flight recorder (:mod:`optuna_tpu_torch.flight`) hooks
#: into :func:`count`: every containment counter increment also lands as an
#: ordered timeline event, with zero new instrumentation at the call sites
#: and zero drift risk between the two surfaces. None (the default) keeps
#: the disabled hot path at module-global checks with no allocations.
_count_sink: Callable[[str, int, dict | None], None] | None = None

#: Optional phase-duration sink the SLO engine (:mod:`optuna_tpu_torch.slo`)
#: hooks into :func:`span`/:func:`observe_phase`: every timed phase also
#: feeds the streaming quantile sketches and burn windows, with zero new
#: instrumentation at the call sites. Independent of :func:`enabled` — the
#: SLO engine evaluates even when the metrics registry is off — and None
#: (the default) keeps the disabled hot path at the shared null span.
_phase_sink: Callable[[str, float], None] | None = None


def _set_count_sink(sink: Callable[[str, int, dict | None], None] | None) -> None:
    global _count_sink
    _count_sink = sink


def _set_phase_sink(sink: Callable[[str, float], None] | None) -> None:
    global _phase_sink
    _phase_sink = sink


class _PhaseSpan:
    """The module-level span: times one block into the enabled registry AND
    the hooked phase sink. Constructed only when at least one consumer is
    on — the disabled path stays the shared :data:`_NULL_SPAN` singleton."""

    __slots__ = ("_name", "_start")

    def __init__(self, name: str) -> None:
        self._name = name

    def __enter__(self) -> "_PhaseSpan":
        self._start = _REGISTRY._clock()
        return self

    def __exit__(self, *exc: object) -> None:
        seconds = _REGISTRY._clock() - self._start
        if _enabled:
            _REGISTRY.observe(_PHASE_METRIC_PREFIX + self._name, seconds)
        sink = _phase_sink
        if sink is not None:
            sink(self._name, seconds)


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _enabled


def enable(registry: MetricsRegistry | None = None) -> None:
    """Turn recording on (optionally swapping in a fresh registry — tests
    and the bench use an isolated one so counts can't bleed across runs)."""
    global _enabled, _REGISTRY
    if registry is not None:
        _REGISTRY = registry
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def count(name: str, n: int = 1, meta: dict | None = None) -> None:
    """Increment a containment counter; a no-op (module-global checks, zero
    allocations) while both telemetry and the flight-recorder sink are
    disabled. ``name`` is a :data:`COUNTERS` family, optionally suffixed
    (``sampler.fallback.relative``). A hooked sink (the flight recorder)
    receives every event even while the metrics registry itself is off —
    the two surfaces are independently switchable, one vocabulary. ``meta``
    is structured context for the sink's timeline event only (the shed
    ladder passes its rung/depth/stale decision); the counter itself stays
    a bare integer."""
    if _count_sink is not None:
        _count_sink(name, n, meta)
    if not _enabled:
        return
    _REGISTRY.inc(name, n)


def observe(name: str, value: float) -> None:
    """Record one value into a histogram; no-op while disabled."""
    if not _enabled:
        return
    _REGISTRY.observe(name, value)


def observe_phase(name: str, seconds: float) -> None:
    """Record one already-measured duration into the ``phase.<name>``
    histogram — for call sites that must stitch one *logical* phase across
    non-contiguous code blocks (the batch executor's ask spans the batch
    creation AND the in-heartbeat suggestion loop), where two ``span()``
    blocks would double the phase's count and halve its per-op latency.
    A hooked phase sink (the SLO engine) receives the observation even
    while the registry is off."""
    if _enabled:
        _REGISTRY.observe(_PHASE_METRIC_PREFIX + name, seconds)
    sink = _phase_sink
    if sink is not None:
        sink(name, seconds)


def set_gauge(name: str, value: float) -> None:
    if not _enabled:
        return
    _REGISTRY.set_gauge(name, value)


def add_gauge(name: str, delta: float) -> None:
    """Accumulate into a gauge (atomic); no-op while disabled."""
    if not _enabled:
        return
    _REGISTRY.add_gauge(name, delta)


def max_gauge(name: str, value: float) -> None:
    """Raise a gauge to ``value`` if larger (atomic); no-op while disabled."""
    if not _enabled:
        return
    _REGISTRY.max_gauge(name, value)


def span(name: str):
    """Time a ``with`` block into the ``phase.<name>`` histogram (and the
    hooked SLO phase sink). Returns a shared do-nothing singleton while
    both consumers are off — the hot path pays two global checks and
    allocates nothing."""
    if not _enabled and _phase_sink is None:
        return _NULL_SPAN
    return _PhaseSpan(name)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def export_snapshot() -> dict:
    """:func:`snapshot` plus the flight recorder's per-label jit
    compile/retrace totals under a ``"jit"`` key — the one export surface
    (``Study.telemetry_snapshot()``, ``/metrics.json``, ``optuna-tpu
    metrics``) that carries host phases, device stats (``device.*`` gauges),
    and compile counts together. The jit totals come from
    :func:`optuna_tpu_torch.flight.jit_totals`, which aggregates even when only
    flight (not the metrics registry) was recording, so a compile that
    happened before ``telemetry.enable()`` still shows up here."""
    snap = snapshot()
    from optuna_tpu_torch import flight

    snap["jit"] = flight.jit_totals()
    return snap


def render_prometheus() -> str:
    """The registry's exposition plus the SLO engine's ``optuna_tpu_slo_*``
    quantile/compliance/burn gauges (empty while the engine is off) — one
    scrape carries counters, histograms, and objective verdicts."""
    from optuna_tpu_torch import slo

    return _REGISTRY.render_prometheus() + slo.prometheus_lines()


def reset() -> None:
    _REGISTRY.reset()


# --------------------------------------------------------------- exports


def phase_totals(snap: Mapping | None = None) -> dict[str, dict[str, float]]:
    """Condense a snapshot's phase histograms to ``{phase: {total_s, count}}``
    — the per-phase breakdown a run reports."""
    snap = snapshot() if snap is None else snap
    out: dict[str, dict[str, float]] = {}
    for name, hist in snap.get("histograms", {}).items():
        if not name.startswith(_PHASE_METRIC_PREFIX) or not hist["count"]:
            continue
        phase = name[len(_PHASE_METRIC_PREFIX):]
        out[phase] = {"total_s": round(hist["sum"], 4), "count": hist["count"]}
    return out


def serve_metrics(
    port: int,
    host: str = "localhost",
    health_source: Callable[[], Mapping] | None = None,
):
    """Serve the registry over HTTP on a daemon thread and return the server
    (call ``.shutdown()`` to stop it). Endpoints: ``/metrics`` (Prometheus
    text, with the SLO engine's ``optuna_tpu_slo_*`` gauges appended while
    it runs), ``/metrics.json`` (the :func:`snapshot` dict), ``/trace.json``
    (the flight recorder's Chrome-trace export — empty ``traceEvents``
    while flight recording is off), ``/slo.json`` (the SLO engine's
    quantile/compliance/burn report — ``enabled: false`` while off),
    ``/autopilot.json`` (the autopilot's action log and cooldown clocks —
    ``enabled: false`` while no control loop is attached), and
    ``/health.json`` (the study doctor's fleet reports: pass
    ``health_source=lambda: health.storage_health_reports(storage)`` in a
    process that can read the whole fleet's storage). Without
    a ``health_source``, ``/health.json`` serves a structured
    ``{"enabled": false, ...}`` payload — the ``/slo.json`` contract — so a
    dashboard probing a source-less process sees "not armed", never a 404
    indistinguishable from a typo'd path. Standard library only. Bind
    ``port=0`` to take a free port (``server.server_address[1]``); stop
    with ``server.shutdown()`` and ``server.server_close()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
            if self.path.split("?")[0] in ("/metrics", "/"):
                body = render_prometheus().encode()
                content_type = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/metrics.json":
                body = json.dumps(export_snapshot()).encode()
                content_type = "application/json"
            elif self.path.split("?")[0] == "/trace.json":
                from optuna_tpu_torch import flight

                body = json.dumps(flight.chrome_trace()).encode()
                content_type = "application/json"
            elif self.path.split("?")[0] == "/slo.json":
                from optuna_tpu_torch import slo

                # Served even while the engine is off (`enabled: false`,
                # empty spec list): a dashboard probing a hub must see "not
                # armed", not a 404 indistinguishable from a typo'd path.
                body = json.dumps(slo.export_report()).encode()
                content_type = "application/json"
            elif self.path.split("?")[0] == "/autopilot.json":
                from optuna_tpu_torch import autopilot

                # Same contract as /slo.json: a probing dashboard must see
                # "not armed" (enabled: false), never a 404.
                body = json.dumps(autopilot.export_report()).encode()
                content_type = "application/json"
            elif self.path.split("?")[0] == "/health.json":
                if health_source is None:
                    # The /slo.json contract: a source-less process answers
                    # with a structured "not armed" payload — a 404 here is
                    # indistinguishable from a typo'd path, and a scraper
                    # cannot tell "doctor not wired" from "wrong URL".
                    body = json.dumps(
                        {
                            "enabled": False,
                            "generated_unix": time.time(),
                            "reports": [],
                            "reason": (
                                "no health_source: this process has no "
                                "storage to aggregate fleet reports over"
                            ),
                        }
                    ).encode()
                    content_type = "application/json"
                else:
                    try:
                        payload = health_source()
                    except Exception as err:  # HTTP boundary: a storage blip while aggregating must come back as a 500 to the scraper, never kill the serving thread
                        self.send_error(500, f"health aggregation failed: {err!r}")
                        return
                    body = json.dumps(payload).encode()
                    content_type = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args: object) -> None:
            return  # scrapes are high-frequency; stay out of the study's logs

    server = ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(
        target=server.serve_forever, name="optuna-tpu-torch-metrics", daemon=True
    )
    thread.start()
    return server


def iter_counter_families() -> Iterator[str]:
    """The counter families (prefix-matched) — export helpers and the chaos
    suite iterate these so a new family cannot be silently untested."""
    return iter(COUNTERS)
