"""SLO engine: streaming latency quantiles, declarative objectives and burn
rates (port of ``optuna_tpu/slo.py``, standard library only).

* :class:`P2Quantile` — the P² streaming quantile estimator (Jain &
  Chlamtac, CACM 1985): five markers, O(1) memory and update, no samples
  retained.
* :class:`SLOEngine` — per-phase quantile sketches plus per-objective
  good/bad counts in a fixed ring of time buckets, fed by the telemetry
  phase-span sink (every ``telemetry.span``/``observe_phase`` call site
  reports here with no instrumentation of its own); the clock is
  injectable so burn-window tests never wait real time.
* :class:`SLOSpec` — one declarative objective ("``serve.ask`` p99 <= 5ms
  over 1h at 99%"): a phase, a latency target, an objective ratio, and an
  evaluation window. The id vocabulary is :data:`SLO_SPECS`, the
  reference's, each with a scenario in
  ``testing/fault_injection.py::SLO_CHAOS_MATRIX``.
* **Multi-window burn rates** — each spec is evaluated over its long
  window and a short window (``window_s / 12``, the 1h/5m pairing); burn
  rate = (violation ratio) / (error budget). A spec is *burning* when BOTH
  windows burn at >= :data:`BURN_WARN` with at least
  :data:`BURN_MIN_VIOLATIONS` long-window violations, and *critical* at
  >= :data:`BURN_CRITICAL` on both.

Consumers: ``optuna_tpu_slo_*`` gauges appended to
``telemetry.render_prometheus()``, ``/slo.json`` beside ``/metrics``, the
``optuna-tpu-torch slo`` CLI and the study doctor's ``service.slo_burn``
check (burn state rides health snapshots over the fleet channel), and the
suggestion service's shed ladder and fleet shed-forward
(:mod:`optuna_tpu_torch.storages._grpc`).

**Off by default**; while disabled the phase sink is unhooked, so
``telemetry.span`` keeps returning its shared null singleton and a study
loop allocates nothing per trial on this module's account. Enabled, every
update is O(1) into fixed-size state. Enable with
``OPTUNA_TPU_TORCH_SLO=1`` or :func:`enable` / :func:`disable` at runtime.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

from optuna_tpu_torch import locksan, telemetry

__all__ = [
    "BURN_CRITICAL",
    "BURN_MIN_VIOLATIONS",
    "BURN_WARN",
    "DEFAULT_QUANTILES",
    "DEFAULT_SLOS",
    "SLO_SPECS",
    "P2Quantile",
    "SLOEngine",
    "SLOSpec",
    "SLOStatus",
    "burn_score",
    "burning_slo_ids",
    "cumulative_counts",
    "disable",
    "enable",
    "enabled",
    "export_report",
    "get_engine",
    "prometheus_lines",
    "render_text",
    "reset",
    "worker_snapshot",
]


# ------------------------------------------------------------- vocabulary

#: The SLO id vocabulary: every objective the engine can evaluate (and every
#: finding/gauge/shed decision derived from one) carries one of these ids.
#: Equal to the reference's, and keyed exactly like
#: ``testing/fault_injection.py::SLO_CHAOS_MATRIX``.
SLO_SPECS: dict[str, str] = {
    "serve.ask.latency": "serve.ask p99 <= 5ms over 1h at 99% (the suggestion service's per-ask contract)",
    "storage.op.latency": "storage.op p99 <= 50ms over 1h at 99.9% (one logical storage op incl. retries)",
    "dispatch.latency": "dispatch p99 <= 30s over 1h at 99% (one objective dispatch, serial or batched)",
    "tell.latency": "tell p99 <= 100ms over 1h at 99.9% (result commit + callbacks)",
    "scan.chunk.latency": "scan.chunk p99 <= 10s over 1h at 99% (one HBM-resident scan-chunk dispatch)",
}

#: Quantiles every sketched phase tracks (specs may add their own): p50 for
#: the bench's steady-state headline, p90/p99 for the tail the SLOs bind.
DEFAULT_QUANTILES: tuple[float, ...] = (0.5, 0.9, 0.99)

#: Burn-rate thresholds (SRE multi-window multi-burn convention): a spec is
#: *burning* when both windows burn at >= BURN_WARN (budget spent exactly at
#: the sustainable rate) and *critical* at >= BURN_CRITICAL on both (the
#: fast-burn page: budget gone in window/6).
BURN_WARN = 1.0
BURN_CRITICAL = 6.0

#: Evidence floor: a verdict needs at least this many long-window
#: violations — one stray slow ask must not halve the shed thresholds.
BURN_MIN_VIOLATIONS = 3


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective: ``<quantile>`` of ``phase`` observations
    must be <= ``target_s``, and the fraction meeting the target over
    ``window_s`` must stay >= ``objective`` (the error budget is
    ``1 - objective``). ``id`` must be registered in :data:`SLO_SPECS`."""

    id: str
    phase: str
    quantile: float
    target_s: float
    objective: float
    window_s: float

    def __post_init__(self) -> None:
        if self.id not in SLO_SPECS:
            raise ValueError(
                f"unknown SLO id {self.id!r}; the vocabulary is "
                f"{sorted(SLO_SPECS)} (SLO_SPECS / SLO_REGISTRY)."
            )
        if self.phase not in telemetry.PHASES:
            raise ValueError(
                f"SLO {self.id!r} names unknown phase {self.phase!r}; phases "
                f"come from telemetry.PHASES."
            )
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1); got {self.quantile}.")
        if self.target_s <= 0.0:
            raise ValueError(f"target_s must be positive; got {self.target_s}.")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1); got {self.objective} "
                "(1.0 leaves no error budget to burn)."
            )
        if self.window_s <= 0.0:
            raise ValueError(f"window_s must be positive; got {self.window_s}.")

    def describe(self) -> str:
        return (
            f"{self.phase} p{self.quantile * 100:g} <= {self.target_s * 1e3:g}ms "
            f"over {self.window_s:g}s at {self.objective:.3%}"
        )


#: The shipped objectives, one per hot phase the sketch attaches to. The id
#: set must equal :data:`SLO_SPECS` exactly (asserted by tests/test_torch_slo.py);
#: ``enable(specs=...)`` swaps in re-parameterized specs (same ids, e.g. a
#: chaos test's floor-level target) without touching the vocabulary.
DEFAULT_SLOS: tuple[SLOSpec, ...] = (
    SLOSpec("serve.ask.latency", "serve.ask", 0.99, 0.005, 0.99, 3600.0),
    SLOSpec("storage.op.latency", "storage.op", 0.99, 0.050, 0.999, 3600.0),
    SLOSpec("dispatch.latency", "dispatch", 0.99, 30.0, 0.99, 3600.0),
    SLOSpec("tell.latency", "tell", 0.99, 0.100, 0.999, 3600.0),
    SLOSpec("scan.chunk.latency", "scan.chunk", 0.99, 10.0, 0.99, 3600.0),
)


# ------------------------------------------------------------- P^2 sketch


class P2Quantile:
    """The P² streaming quantile estimator (Jain & Chlamtac, CACM 28(10),
    1985): five markers whose heights approximate the q-quantile and its
    neighborhood, adjusted per observation by a piecewise-parabolic fit.
    O(1) memory, O(1) update, no samples retained — a week of serve-path
    observations costs the same five floats as the first five.

    Not thread-safe on its own: the owning :class:`SLOEngine` serializes
    updates under its lock (one lock per engine, the MetricsRegistry
    discipline).
    """

    __slots__ = ("q", "count", "_heights", "_positions", "_desired", "_rates")

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1); got {q}.")
        self.q = q
        self.count = 0
        self._heights: list[float] = []
        self._positions = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._rates = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self.count <= 5:
            bisect.insort(self._heights, x)
            return
        h, n = self._heights, self._positions
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while not (h[k] <= x < h[k + 1]):
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._desired[i] += self._rates[i]
        for i in (1, 2, 3):
            d = self._desired[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                d = 1.0 if d > 0 else -1.0
                candidate = self._parabolic(i, d)
                if not h[i - 1] < candidate < h[i + 1]:
                    candidate = self._linear(i, d)
                h[i] = candidate
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._heights, self._positions
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, n = self._heights, self._positions
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> float:
        """The current estimate (exact while count <= 5; 0.0 when empty)."""
        if self.count == 0:
            return 0.0
        if self.count <= 5:
            ordered = self._heights  # insort keeps them sorted
            return ordered[min(len(ordered) - 1, int(self.q * len(ordered)))]
        return self._heights[2]


# ------------------------------------------------------------ burn window


class _BurnWindow:
    """Good/bad observation counts over trailing long and short windows,
    held in a fixed ring of time buckets: no per-observation allocation,
    no timestamps retained. The short window is ``window_s / 12`` (the
    1h/5m multi-window pairing); bucket granularity is ``window_s / 60``
    so the short window spans its own five buckets."""

    N_BUCKETS = 60
    SHORT_DIVISOR = 12

    __slots__ = ("window_s", "bucket_s", "_good", "_bad", "_epochs")

    def __init__(self, window_s: float) -> None:
        self.window_s = float(window_s)
        self.bucket_s = self.window_s / self.N_BUCKETS
        self._good = [0] * self.N_BUCKETS
        self._bad = [0] * self.N_BUCKETS
        self._epochs = [-1] * self.N_BUCKETS

    def record(self, ok: bool, now: float) -> None:
        epoch = int(now // self.bucket_s)
        slot = epoch % self.N_BUCKETS
        if self._epochs[slot] != epoch:  # the ring lapped: recycle the slot
            self._epochs[slot] = epoch
            self._good[slot] = 0
            self._bad[slot] = 0
        if ok:
            self._good[slot] += 1
        else:
            self._bad[slot] += 1

    def totals(self, now: float) -> tuple[int, int, int, int]:
        """``(good_long, bad_long, good_short, bad_short)`` at ``now``."""
        epoch = int(now // self.bucket_s)
        short_span = max(1, self.N_BUCKETS // self.SHORT_DIVISOR)
        good_long = bad_long = good_short = bad_short = 0
        for slot in range(self.N_BUCKETS):
            slot_epoch = self._epochs[slot]
            if slot_epoch < 0:
                continue
            age = epoch - slot_epoch
            if age < 0 or age >= self.N_BUCKETS:
                continue  # expired (or a clock injection jumped backwards)
            good_long += self._good[slot]
            bad_long += self._bad[slot]
            if age < short_span:
                good_short += self._good[slot]
                bad_short += self._bad[slot]
        return good_long, bad_long, good_short, bad_short


# ----------------------------------------------------------------- engine


@dataclass(frozen=True)
class SLOStatus:
    """One spec's current verdict: windowed counts, compliance ratios,
    multi-window burn rates, and the sketch estimate at the spec's
    quantile."""

    spec: SLOSpec
    estimate_s: float
    quantiles_s: Mapping[float, float]
    good_long: int
    bad_long: int
    good_short: int
    bad_short: int

    @staticmethod
    def _ratio(bad: int, total: int) -> float:
        return (bad / total) if total else 0.0

    @property
    def compliance_long(self) -> float:
        return 1.0 - self._ratio(self.bad_long, self.good_long + self.bad_long)

    @property
    def compliance_short(self) -> float:
        return 1.0 - self._ratio(self.bad_short, self.good_short + self.bad_short)

    @property
    def burn_long(self) -> float:
        budget = 1.0 - self.spec.objective
        return self._ratio(self.bad_long, self.good_long + self.bad_long) / budget

    @property
    def burn_short(self) -> float:
        budget = 1.0 - self.spec.objective
        return self._ratio(self.bad_short, self.good_short + self.bad_short) / budget

    @property
    def burning(self) -> bool:
        """Both windows burning at >= :data:`BURN_WARN` with the long-window
        evidence floor met — the two-window AND that keeps one slow ask
        from flapping the shed ladder."""
        return (
            self.bad_long >= BURN_MIN_VIOLATIONS
            and self.burn_long >= BURN_WARN
            and self.burn_short >= BURN_WARN
        )

    @property
    def critical(self) -> bool:
        return (
            self.burning
            and self.burn_long >= BURN_CRITICAL
            and self.burn_short >= BURN_CRITICAL
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.spec.id,
            "phase": self.spec.phase,
            "quantile": self.spec.quantile,
            "target_s": self.spec.target_s,
            "objective": self.spec.objective,
            "window_s": self.spec.window_s,
            "description": self.spec.describe(),
            "estimate_s": self.estimate_s,
            "quantiles_s": {f"{q:g}": v for q, v in sorted(self.quantiles_s.items())},
            "observations": {
                "long": {"good": self.good_long, "bad": self.bad_long},
                "short": {"good": self.good_short, "bad": self.bad_short},
            },
            "compliance": {
                "long": round(self.compliance_long, 6),
                "short": round(self.compliance_short, 6),
            },
            "burn_rate": {
                "long": round(self.burn_long, 4),
                "short": round(self.burn_short, 4),
            },
            "burning": self.burning,
            "critical": self.critical,
        }


class SLOEngine:
    """Quantile sketches + burn windows for a fixed spec set.

    Fed by the telemetry phase sink (:func:`enable` hooks
    ``telemetry._set_phase_sink``), so every existing
    ``telemetry.span``/``observe_phase`` call site reports here without new
    instrumentation — one vocabulary, zero drift risk. ``clock`` drives the
    burn-window buckets and is injectable like
    :class:`~optuna_tpu_torch.telemetry.MetricsRegistry`'s. Thread-safe: one lock
    serializes updates and evaluations (the hot path is a dict probe plus a
    handful of float ops under it).
    """

    def __init__(
        self,
        specs: Sequence[SLOSpec] | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        quantiles: Sequence[float] = DEFAULT_QUANTILES,
    ) -> None:
        specs = tuple(DEFAULT_SLOS if specs is None else specs)
        seen: set[str] = set()
        for spec in specs:
            if spec.id in seen:
                raise ValueError(f"duplicate SLO id {spec.id!r} in the spec set.")
            seen.add(spec.id)
        self.specs = specs
        self.quantiles = tuple(quantiles)  # retained so reset() can rebuild
        self._clock = clock
        self._lock = locksan.lock("slo.engine")
        self._by_phase: dict[str, tuple[SLOSpec, ...]] = {}
        for spec in specs:
            self._by_phase[spec.phase] = self._by_phase.get(spec.phase, ()) + (spec,)
        self._sketches: dict[str, dict[float, P2Quantile]] = {
            phase: {
                q: P2Quantile(q)
                for q in sorted(
                    set(quantiles) | {spec.quantile for spec in phase_specs}
                )
            }
            for phase, phase_specs in self._by_phase.items()
        }
        self._windows = {spec.id: _BurnWindow(spec.window_s) for spec in specs}
        #: Cumulative (good, bad) per spec since construction — the delta
        #: base for health-snapshot publishing (windows forget; these don't).
        self._cumulative = {spec.id: [0, 0] for spec in specs}

    def observe(self, phase: str, seconds: float) -> None:
        """The phase-sink entry point: one timed phase observation."""
        specs = self._by_phase.get(phase)
        if specs is None:
            return  # not a sketched phase: one dict probe and out
        with self._lock:
            for estimator in self._sketches[phase].values():
                estimator.observe(seconds)
            now = self._clock()
            for spec in specs:
                ok = seconds <= spec.target_s
                self._windows[spec.id].record(ok, now)
                self._cumulative[spec.id][0 if ok else 1] += 1

    def status(self) -> list[SLOStatus]:
        with self._lock:
            now = self._clock()
            out = []
            for spec in self.specs:
                sketch = self._sketches[spec.phase]
                good_long, bad_long, good_short, bad_short = self._windows[
                    spec.id
                ].totals(now)
                out.append(
                    SLOStatus(
                        spec=spec,
                        estimate_s=sketch[spec.quantile].value(),
                        quantiles_s={q: est.value() for q, est in sketch.items()},
                        good_long=good_long,
                        bad_long=bad_long,
                        good_short=good_short,
                        bad_short=bad_short,
                    )
                )
            return out

    def cumulative_counts(self) -> dict[str, tuple[int, int]]:
        """Per-spec ``(good, bad)`` since construction — monotone, so a
        consumer can baseline and publish deltas (the health reporter)."""
        with self._lock:
            return {spec_id: (c[0], c[1]) for spec_id, c in self._cumulative.items()}


# ------------------------------------------------- module-level fast path

_ENGINE: SLOEngine | None = None
_enabled = False


def _env_enabled() -> bool:
    raw = os.environ.get("OPTUNA_TPU_TORCH_SLO", "").strip()
    return bool(raw) and raw.lower() not in ("0", "false", "no", "off")


def enabled() -> bool:
    return _enabled


def get_engine() -> SLOEngine | None:
    return _ENGINE


def enable(
    specs: Sequence[SLOSpec] | None = None,
    *,
    clock: Callable[[], float] | None = None,
    quantiles: Sequence[float] | None = None,
) -> None:
    """Turn evaluation on and hook the telemetry phase sink. Passing any of
    ``specs``/``clock``/``quantiles`` builds a fresh engine (tests and the
    bench isolate theirs); a bare ``enable()`` keeps the current one."""
    global _enabled, _ENGINE
    if specs is not None or clock is not None or quantiles is not None or _ENGINE is None:
        _ENGINE = SLOEngine(
            specs,
            clock=clock if clock is not None else time.monotonic,
            quantiles=quantiles if quantiles is not None else DEFAULT_QUANTILES,
        )
    _enabled = True
    telemetry._set_phase_sink(_ENGINE.observe)


def disable() -> None:
    """Unhook the sink: the disabled hot path goes back to the shared null
    span and zero per-trial allocations."""
    global _enabled
    _enabled = False
    telemetry._set_phase_sink(None)


def reset() -> None:
    """Forget every sketch and window (fresh engine, same specs, same
    quantiles, same clock)."""
    global _ENGINE
    if _ENGINE is not None:
        _ENGINE = SLOEngine(
            _ENGINE.specs, clock=_ENGINE._clock, quantiles=_ENGINE.quantiles
        )
        if _enabled:
            telemetry._set_phase_sink(_ENGINE.observe)


# ----------------------------------------------------------------- exports


def export_report() -> dict[str, Any]:
    """The one report shape every surface serves (``/slo.json``,
    ``optuna-tpu-torch slo``): enablement, spec verdicts, burn rates."""
    statuses = _ENGINE.status() if (_ENGINE is not None and _enabled) else []
    return {
        "enabled": _enabled,
        "generated_unix": time.time(),
        "slos": [status.to_dict() for status in statuses],
        "burning": [status.spec.id for status in statuses if status.burning],
    }


def burning_slo_ids() -> tuple[str, ...]:
    """Ids of specs currently burning their error budget — the shed
    policy's feed (empty while disabled: an un-armed engine never sheds)."""
    if not _enabled or _ENGINE is None:
        return ()
    return tuple(status.spec.id for status in _ENGINE.status() if status.burning)


def burn_score() -> float:
    """One scalar "how burnt is this process": ``0.0`` while disabled or
    healthy, the worst burning spec's long-window burn rate while burning,
    ``inf`` once any spec is critical. The hub fleet exchanges this over
    the peer channel (``service_burn_verdict``) to rank shed-forward
    targets — comparisons only, so the scale just has to be monotone in
    badness."""
    if not _enabled or _ENGINE is None:
        return 0.0
    score = 0.0
    for status in _ENGINE.status():
        if status.critical:
            return float("inf")
        if status.burning:
            score = max(score, status.burn_long)
    return score


def cumulative_counts() -> dict[str, tuple[int, int]]:
    """Per-spec cumulative ``(good, bad)`` — the health reporter's delta
    baseline (empty while disabled)."""
    if not _enabled or _ENGINE is None:
        return {}
    return _ENGINE.cumulative_counts()


def worker_snapshot(
    baseline: Mapping[str, tuple[int, int]] | None = None,
) -> dict[str, dict[str, Any]]:
    """The bounded per-worker SLO block the health reporter publishes:
    good/bad deltas vs ``baseline`` plus the current windowed burn rates
    and sketch estimate, per spec with activity. Specs with nothing to say
    are omitted so the study attr stays kilobytes."""
    if not _enabled or _ENGINE is None:
        return {}
    baseline = baseline or {}
    out: dict[str, dict[str, Any]] = {}
    cumulative = _ENGINE.cumulative_counts()
    by_id = {status.spec.id: status for status in _ENGINE.status()}
    for spec_id, (good, bad) in cumulative.items():
        base_good, base_bad = baseline.get(spec_id, (0, 0))
        good_delta, bad_delta = good - base_good, bad - base_bad
        status = by_id[spec_id]
        if good_delta <= 0 and bad_delta <= 0 and not status.burning:
            continue
        out[spec_id] = {
            "good": good_delta,
            "bad": bad_delta,
            "burn_long": round(status.burn_long, 4),
            "burn_short": round(status.burn_short, 4),
            # The two-window AND is evaluated HERE, per worker: the fleet
            # merge maxes the windows independently (each is evidence), so
            # recomputing the AND from merged maxes could combine one
            # worker's long spike with another's short blip into a verdict
            # no single worker holds. The booleans are the verdicts.
            "burning": status.burning,
            "critical": status.critical,
            "objective": status.spec.objective,
            "target_s": status.spec.target_s,
            "quantile": status.spec.quantile,
            "estimate_s": round(status.estimate_s, 9),
        }
    return out


def prometheus_lines() -> str:
    """``optuna_tpu_slo_*`` gauges appended to the telemetry exposition:
    per-spec quantile estimates, per-window compliance ratios, and burn
    rates — empty while disabled so a plain metrics scrape is unchanged."""
    if not _enabled or _ENGINE is None:
        return ""
    from optuna_tpu_torch.telemetry import _escape_label_value, _format_value

    lines: list[str] = []
    statuses = _ENGINE.status()
    if not statuses:
        return ""

    def label(spec: SLOSpec, **extra: str) -> str:
        pairs = {"slo": spec.id, "phase": spec.phase, **extra}
        inner = ",".join(
            f'{k}="{_escape_label_value(v)}"' for k, v in pairs.items()
        )
        return "{" + inner + "}"

    lines.append("# TYPE optuna_tpu_slo_quantile_seconds gauge")
    for status in statuses:
        for q, value in sorted(status.quantiles_s.items()):
            lines.append(
                f"optuna_tpu_slo_quantile_seconds"
                f"{label(status.spec, quantile=f'{q:g}')} {_format_value(value)}"
            )
    lines.append("# TYPE optuna_tpu_slo_compliance_ratio gauge")
    for status in statuses:
        lines.append(
            f"optuna_tpu_slo_compliance_ratio{label(status.spec, window='long')} "
            f"{_format_value(status.compliance_long)}"
        )
        lines.append(
            f"optuna_tpu_slo_compliance_ratio{label(status.spec, window='short')} "
            f"{_format_value(status.compliance_short)}"
        )
    lines.append("# TYPE optuna_tpu_slo_burn_rate gauge")
    for status in statuses:
        lines.append(
            f"optuna_tpu_slo_burn_rate{label(status.spec, window='long')} "
            f"{_format_value(status.burn_long)}"
        )
        lines.append(
            f"optuna_tpu_slo_burn_rate{label(status.spec, window='short')} "
            f"{_format_value(status.burn_short)}"
        )
    lines.append("# TYPE optuna_tpu_slo_burning gauge")
    for status in statuses:
        lines.append(
            f"optuna_tpu_slo_burning{label(status.spec)} "
            f"{1 if status.burning else 0}"
        )
    return "\n".join(lines) + "\n"


def render_text(report: Mapping[str, Any]) -> str:
    """The ``optuna-tpu-torch slo`` table rendering: one verdict line per spec."""
    lines: list[str] = []
    if not report.get("enabled"):
        lines.append(
            "SLO engine disabled (enable with OPTUNA_TPU_TORCH_SLO=1 or slo.enable())"
        )
    slos = report.get("slos", [])
    if not slos and report.get("enabled"):
        lines.append("no SLO specs registered")
    for entry in slos:
        if entry.get("critical"):
            verdict = "CRITICAL BURN"
        elif entry.get("burning"):
            verdict = "BURNING"
        else:
            verdict = "ok"
        burn = entry.get("burn_rate", {})
        comp = entry.get("compliance", {})
        obs = entry.get("observations", {}).get("long", {})
        lines.append(
            f"[{verdict}] {entry['id']}: {entry.get('description', '')} — "
            f"p{entry['quantile'] * 100:g}={entry['estimate_s'] * 1e3:.3f}ms, "
            f"compliance long={comp.get('long', 1.0):.4f} "
            f"short={comp.get('short', 1.0):.4f}, "
            f"burn long={burn.get('long', 0.0):g}x short={burn.get('short', 0.0):g}x "
            f"({obs.get('good', 0)} good / {obs.get('bad', 0)} bad)"
        )
    return "\n".join(lines)


# The environment switch mirrors telemetry's/flight's/health's: set before
# import, evaluation is armed from trial zero.
if _env_enabled():
    enable()
