"""Telemetry registry: host-side metrics for the study loop (port of the
registry core of ``optuna_tpu/telemetry.py``).

* :class:`MetricsRegistry` — counters, gauges, and monotonic-clock
  histograms with fixed log-spaced buckets; the clock is injectable so
  tests assert timings without real waiting.
* ``span(name)`` — a context manager timing one phase of the study loop
  into the ``phase.<name>`` histogram. Phase names come from the
  :data:`PHASES` vocabulary; :func:`trace_name` gives the same phase's
  ``torch.profiler`` range name, so profiler timelines and metrics
  histograms line up one-to-one.
* ``count(name)`` — containment counters (:data:`COUNTERS` vocabulary).
* :func:`snapshot` (a JSON-able dict) and :func:`phase_totals`.

Telemetry is **off** by default, and the disabled hot path is module-global
checks only: ``count`` returns immediately and ``span`` returns a shared
singleton null context, so a disabled study loop allocates nothing per
trial on this module's account. Enable with ``OPTUNA_TPU_TORCH_TELEMETRY=1``
in the environment, or :func:`enable` / :func:`disable` at runtime.

The Prometheus rendering, ``serve_metrics`` and the flight-recorder and SLO
sinks are not ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Mapping

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
    "get_registry",
    "max_gauge",
    "observe",
    "observe_phase",
    "phase_totals",
    "reset",
    "set_gauge",
    "snapshot",
    "span",
    "trace_name",
]


# ------------------------------------------------------------- vocabulary

#: The study-loop phase vocabulary: every ``span()`` name draws from it,
#: spelled ``phase.<phase>`` in metrics and ``optuna_tpu_torch.<phase>`` on
#: the profiler timeline.
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
#: sub-family at the call site (e.g. ``sampler.fallback.relative``).
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
#: to ~100 s. Fixed so every phase histogram is cross-comparable.
BUCKET_BOUNDS: tuple[float, ...] = tuple(10.0 ** (k / 2.0) for k in range(-10, 5))


class HistogramState:
    """One histogram's live state: total count/sum plus raw per-bucket
    counts over the fixed :data:`BUCKET_BOUNDS` ladder (+Inf tail last)."""

    __slots__ = ("count", "total", "bucket_counts")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.bucket_counts = [0] * (len(BUCKET_BOUNDS) + 1)

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        for i, bound in enumerate(BUCKET_BOUNDS):
            if value <= bound:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1


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

    ``clock`` is injectable for deterministic span tests; it must be
    monotonic (wall clocks jump under NTP).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, HistogramState] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def add_gauge(self, name: str, delta: float) -> None:
        """Accumulate into a gauge atomically (read-modify-write under the
        registry lock)."""
        with self._lock:
            self._gauges[name] = self._gauges.get(name, 0.0) + float(delta)

    def max_gauge(self, name: str, value: float) -> None:
        """Raise a gauge to ``value`` if larger, atomically (high-water
        marks such as the max ladder rung)."""
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
                    f"{bound:.6g}": hist.bucket_counts[i] for i, bound in enumerate(BUCKET_BOUNDS)
                }
                buckets["+Inf"] = hist.bucket_counts[-1]
                histograms[name] = {"count": hist.count, "sum": hist.total, "buckets": buckets}
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": histograms,
            }


# ------------------------------------------------- module-level fast path

_REGISTRY = MetricsRegistry()
_enabled = bool(os.environ.get("OPTUNA_TPU_TORCH_TELEMETRY"))


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _enabled


def enable(registry: MetricsRegistry | None = None) -> None:
    """Turn recording on (optionally swapping in a fresh registry, so counts
    cannot bleed across runs)."""
    global _enabled, _REGISTRY
    if registry is not None:
        _REGISTRY = registry
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def count(name: str, n: int = 1) -> None:
    """Increment a containment counter; a no-op while disabled. ``name`` is
    a :data:`COUNTERS` family, optionally suffixed."""
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
    histogram, for a phase that spans code blocks which are not contiguous
    (the batch executor's ask covers the batch creation and the
    suggestions inside the heartbeat): two ``span()`` blocks would double
    the phase's count and halve its time an operation. A no-op while
    disabled."""
    if not _enabled:
        return
    _REGISTRY.observe(_PHASE_METRIC_PREFIX + name, seconds)


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
    """Time a ``with`` block into the ``phase.<name>`` histogram. Returns a
    shared do-nothing singleton while disabled."""
    if not _enabled:
        return _NULL_SPAN
    return _REGISTRY.span(name)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()


def phase_totals(snap: Mapping | None = None) -> dict[str, dict[str, float]]:
    """Condense a snapshot's phase histograms to ``{phase: {total_s, count}}``."""
    snap = snapshot() if snap is None else snap
    out: dict[str, dict[str, float]] = {}
    for name, hist in snap.get("histograms", {}).items():
        if not name.startswith(_PHASE_METRIC_PREFIX) or not hist["count"]:
            continue
        phase = name[len(_PHASE_METRIC_PREFIX):]
        out[phase] = {"total_s": round(hist["sum"], 4), "count": hist["count"]}
    return out
