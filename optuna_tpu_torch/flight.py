"""Flight recorder: a per-trial trace timeline (port of
``optuna_tpu/flight.py``).

The telemetry registry (:mod:`optuna_tpu_torch.telemetry`) answers "how
much / how often"; this module answers "what happened, in what order, to
*this* trial":

* :class:`FlightRecorder` — a bounded ring buffer (``collections.deque``)
  of structured :class:`FlightEvent` entries, flat in memory however long
  the study runs.
* **One vocabulary** — span events use the telemetry phase names
  (``telemetry.PHASES``), so the flight timeline, the metrics histograms
  and the ``torch.profiler`` ranges of :mod:`optuna_tpu_torch._tracing`
  line up name for name; containment events use the counter families
  (``telemetry.COUNTERS``) and are fed from every ``telemetry.count`` call
  site through a sink hook. Event *kinds* are the :data:`EVENT_KINDS`
  vocabulary (the reference's kinds).
* **Runtime compile gauges** — :func:`instrument_jit` keeps the reference's
  name and gauges (``jit.compiles.<label>``, ``jit.compile_seconds.<label>``,
  ``jit.retraces_after_first.<label>``, :func:`jit_totals`). Eager PyTorch
  has no executable cache to size, so the proxy counts a "compile" the
  first time it sees a call *signature* — the shapes, dtypes and devices of
  the tensor arguments, and the other arguments — and times that call to
  its end; any later new signature is a retrace (the reference's rule:
  cache growth after the first entry). The kernels' ``nvcc`` build and
  load at first use records a ``jit.compile`` under ``kernel.<source stem>``
  (:func:`note_kernel_build`). :func:`sample_device_gauges` reads
  ``torch.cuda.memory_stats()`` into ``hbm.live_bytes`` / ``hbm.peak_bytes``.
* **Three delivery surfaces** — (1) Chrome-trace/Perfetto JSON
  (:func:`chrome_trace`, ``Study.trace_snapshot()``, the
  ``optuna-tpu-torch trace`` CLI, and ``/trace.json`` from
  ``telemetry.serve_metrics``); (2) cross-process propagation
  (:func:`rpc_span` / :func:`rpc_context`, which the gRPC tier's client
  and server stitch); (3) postmortems: :func:`postmortem` flushes the ring's tail as
  bounded JSON when a batch fails terminally, a watchdog fires, or a
  ``GuardedSampler`` first degrades.

**Off by default**; the disabled hot path is a module-global check —
``span`` returns one shared null singleton, ``event`` returns immediately
— so a disabled study loop allocates nothing per trial on this module's
account. Recording is strictly host-side.

Enable with ``OPTUNA_TPU_TORCH_FLIGHT=1`` (optionally ``=<capacity>``) in
the environment, or :func:`enable` / :func:`disable` at runtime; dumps land
in ``$OPTUNA_TPU_TORCH_FLIGHT_DUMP_DIR`` (default: the system temp dir).
"""

from __future__ import annotations

import enum
import itertools
import json
import os
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Iterable, Mapping

import numpy as np

from optuna_tpu_torch import locksan, telemetry

__all__ = [
    "EVENT_KINDS",
    "FlightEvent",
    "FlightRecorder",
    "chrome_trace",
    "clear",
    "disable",
    "enable",
    "enabled",
    "event",
    "events",
    "filter_chrome_trace",
    "filter_trial",
    "flow",
    "get_recorder",
    "instrument_jit",
    "jit_totals",
    "last_postmortem_path",
    "new_flow_id",
    "new_span_id",
    "postmortem",
    "reset_jit_totals",
    "rpc_span",
    "sample_device_gauges",
    "snapshot",
    "span",
    "trace_id",
    "trial_event",
]


# ------------------------------------------------------------- vocabulary

#: The event-kind vocabulary: every recorded event carries exactly one of
#: these kinds (validated on record). Span *names* within the ``phase`` kind
#: come from ``telemetry.PHASES``; ``containment`` names from
#: ``telemetry.COUNTERS`` families. The kinds are the reference's, and each
#: has a scenario in ``testing/fault_injection.py::FLIGHT_EVENT_CHAOS_MATRIX``.
EVENT_KINDS: dict[str, str] = {
    "phase": "a timed study-loop phase span (names: the telemetry phase vocabulary)",
    "trial": "a trial lifecycle instant (ask'd / told) carrying the trial number",
    "containment": "a containment event (names: the telemetry counter families)",
    "rpc.client": "a gRPC client op span carrying this worker's trace/span ids",
    "rpc.server": "a gRPC server handler span tagged with the calling client's span",
    "jit.compile": "an instrumented callable met a new call signature (or a kernel library was built and loaded): a compile, with call seconds",
    "jit.retrace": "an instrumented callable met a new signature after its first",
    "gauge": "a sampled runtime device gauge (device memory high-water)",
    "postmortem": "the recorder tail was flushed to a bounded JSON dump",
    "flow": "a causal flow-edge endpoint (fan-in to a coalesced dispatch / fan-out from a refill), rendered as a Perfetto flow arrow",
}

#: Ring capacity when the environment/enable() doesn't say otherwise: deep
#: enough for thousands of trials' spans, shallow enough to stay megabytes.
DEFAULT_CAPACITY = 8192

#: Postmortem dumps flush at most this many trailing events — bounded JSON
#: no matter how large a capacity the operator configured.
POSTMORTEM_TAIL = 1024

_DUMP_DIR_ENV = "OPTUNA_TPU_TORCH_FLIGHT_DUMP_DIR"


# ----------------------------------------------------------------- events


class FlightEvent:
    """One structured timeline entry. ``ts`` is wall-clock seconds (an epoch
    anchor is added to the injectable monotonic clock, so timestamps are
    orderable across processes on one host); ``dur`` is span seconds or
    None for instants; ``trace``/``span``/``parent`` stitch cross-process
    causality."""

    __slots__ = ("ts", "kind", "name", "dur", "trial", "trace", "span", "parent", "tid", "meta")

    def __init__(
        self,
        ts: float,
        kind: str,
        name: str,
        dur: float | None = None,
        trial: int | None = None,
        trace: str | None = None,
        span: str | None = None,
        parent: str | None = None,
        tid: int = 0,
        meta: dict | None = None,
    ) -> None:
        self.ts = ts
        self.kind = kind
        self.name = name
        self.dur = dur
        self.trial = trial
        self.trace = trace
        self.span = span
        self.parent = parent
        self.tid = tid
        self.meta = meta

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"ts": self.ts, "kind": self.kind, "name": self.name}
        if self.dur is not None:
            out["dur"] = self.dur
        if self.trial is not None:
            out["trial"] = self.trial
        if self.trace is not None:
            out["trace"] = self.trace
        if self.span is not None:
            out["span"] = self.span
        if self.parent is not None:
            out["parent"] = self.parent
        out["tid"] = self.tid
        if self.meta:
            out["meta"] = self.meta
        return out

    def __repr__(self) -> str:  # compact test/debug rendering
        return f"FlightEvent({self.kind}:{self.name} @{self.ts:.6f} trial={self.trial})"


class _FlightSpan:
    """Times one ``with`` block into the ring as a completed span event."""

    __slots__ = ("_recorder", "_kind", "_name", "_trial", "_parent", "_trace", "_meta", "_t0", "span_id")

    def __init__(
        self,
        recorder: "FlightRecorder",
        kind: str,
        name: str,
        trial: int | None,
        parent: str | None,
        trace: str | None,
        meta: dict | None,
        span_id: str | None,
    ) -> None:
        self._recorder = recorder
        self._kind = kind
        self._name = name
        self._trial = trial
        self._parent = parent
        self._trace = trace
        self._meta = meta
        self.span_id = span_id if span_id is not None else recorder.new_span_id()

    def __enter__(self) -> "_FlightSpan":
        self._t0 = self._recorder._clock()
        return self

    def __exit__(self, *exc: object) -> None:
        recorder = self._recorder
        recorder.record(
            self._kind,
            self._name,
            ts=self._t0 + recorder._epoch,
            dur=recorder._clock() - self._t0,
            trial=self._trial,
            trace=self._trace,
            span=self.span_id,
            parent=self._parent,
            meta=self._meta,
        )


class _NullSpan:
    """The disabled-path span: one shared instance, allocates nothing."""

    __slots__ = ()
    span_id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None


_NULL_SPAN = _NullSpan()


# --------------------------------------------------------------- recorder


class FlightRecorder:
    """Thread-safe bounded ring of :class:`FlightEvent` entries.

    ``clock`` is injectable (monotonic) for deterministic tests, like
    :class:`~optuna_tpu_torch.telemetry.MetricsRegistry`; ``epoch`` anchors it to
    wall time so exported timestamps are comparable across the processes of
    one study. One recorder = one ``trace id`` — the identity that
    propagates over gRPC so a fleet's events stitch into one timeline.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        clock: Callable[[], float] = time.monotonic,
        epoch: float | None = None,
        trace_id: str | None = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}.")
        self.capacity = capacity
        self._clock = clock
        self._epoch = (time.time() - clock()) if epoch is None else epoch
        self.trace_id = trace_id if trace_id is not None else uuid.uuid4().hex[:16]
        self._events: deque[FlightEvent] = deque(maxlen=capacity)
        self._span_seq = itertools.count(1)
        self._pid = os.getpid()

    def now(self) -> float:
        return self._clock() + self._epoch

    def new_span_id(self) -> str:
        return f"{self._pid:x}.{next(self._span_seq):x}"

    def record(
        self,
        kind: str,
        name: str,
        *,
        ts: float | None = None,
        dur: float | None = None,
        trial: int | None = None,
        trace: str | None = None,
        span: str | None = None,
        parent: str | None = None,
        meta: dict | None = None,
    ) -> FlightEvent:
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown flight event kind {kind!r}; the vocabulary is "
                f"{sorted(EVENT_KINDS)} (EVENT_KINDS / FLIGHT_EVENT_REGISTRY)."
            )
        ev = FlightEvent(
            ts=self.now() if ts is None else ts,
            kind=kind,
            name=name,
            dur=dur,
            trial=trial,
            trace=self.trace_id if trace is None else trace,
            span=span,
            parent=parent,
            tid=threading.get_ident(),
            meta=meta,
        )
        self._events.append(ev)  # deque.append is atomic; maxlen bounds it
        return ev

    def events(self) -> list[FlightEvent]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()


# ------------------------------------------------- module-level fast path

_RECORDER = FlightRecorder()
_enabled = False
_postmortem_keys: set[str] = set()
_postmortem_seq = itertools.count(1)
_last_postmortem_path: str | None = None


def _env_capacity() -> int | None:
    """Parse ``OPTUNA_TPU_TORCH_FLIGHT``: None = stay disabled (unset, empty, or an
    explicit disable spelling — ``0``/``false``/``no``/``off`` must not arm
    the recorder the operator just opted out of), an int >= 2 = that ring
    capacity, anything else truthy (``1``/``true``/``yes``) = the default."""
    raw = os.environ.get("OPTUNA_TPU_TORCH_FLIGHT", "").strip()
    if not raw or raw.lower() in ("false", "no", "off"):
        return None
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_CAPACITY  # OPTUNA_TPU_TORCH_FLIGHT=true/yes style
    if n <= 0:
        return None
    return n if n > 1 else DEFAULT_CAPACITY


def get_recorder() -> FlightRecorder:
    return _RECORDER


def enabled() -> bool:
    return _enabled


def trace_id() -> str:
    return _RECORDER.trace_id


def new_span_id() -> str:
    return _RECORDER.new_span_id()


def enable(recorder: FlightRecorder | None = None, *, capacity: int | None = None) -> None:
    """Turn recording on (optionally swapping in a fresh recorder — tests
    and the CLI use an isolated one so timelines can't bleed across runs).
    Also hooks the telemetry counter sink so every existing
    ``telemetry.count`` call site lands a ``containment`` event here with
    zero new instrumentation at those sites."""
    global _enabled, _RECORDER
    if recorder is not None:
        _RECORDER = recorder
        _postmortem_keys.clear()  # a fresh recorder is a fresh session
    elif capacity is not None and capacity != _RECORDER.capacity:
        _RECORDER = FlightRecorder(capacity=capacity)
        _postmortem_keys.clear()
    _enabled = True
    telemetry._set_count_sink(_containment_sink)


def disable() -> None:
    global _enabled
    _enabled = False
    telemetry._set_count_sink(None)


def clear() -> None:
    _RECORDER.clear()
    _postmortem_keys.clear()


def _containment_sink(name: str, n: int, meta: dict | None = None) -> None:
    """The ``telemetry.count`` hook: every containment counter increment is
    also an ordered timeline event (kind ``containment``), so the chaos
    postmortem can show *when* a quarantine/bisection/retry fired relative
    to the trial lifecycle — the counters alone only say that it did.
    ``meta`` is the call site's structured decision context (the shed
    ladder's rung/depth/stale), carried onto the event verbatim."""
    if n != 1:
        meta = {**(meta or {}), "n": n}
    _RECORDER.record("containment", name, meta=meta)


# ----------------------------------------------------------- record entry


def span(name: str, trial: int | None = None):
    """Time a ``with`` block as a ``phase`` span (``name`` must be a
    telemetry phase). Returns a shared do-nothing singleton while disabled —
    one module-global check, zero allocations on the hot path."""
    if not _enabled:
        return _NULL_SPAN
    return _FlightSpan(_RECORDER, "phase", name, trial, None, None, None, None)


def event(
    kind: str,
    name: str,
    trial: int | None = None,
    meta: dict | None = None,
) -> None:
    """Record one instant event; a no-op while disabled."""
    if not _enabled:
        return
    _RECORDER.record(kind, name, trial=trial, meta=meta)


def new_flow_id() -> str:
    """Mint a process-unique flow id (one per causal edge: a parked ask, a
    minted ready-queue proposal). The span-id sequence is reused — both are
    opaque per-recorder identifiers."""
    return _RECORDER.new_span_id()


def flow(
    name: str,
    flow_id: str,
    direction: str,
    trial: int | None = None,
    meta: dict | None = None,
) -> None:
    """Record one causal flow-edge endpoint; a no-op while disabled.

    ``direction`` is ``"out"`` at the edge's source (a parked ask about to
    fan into a coalesced dispatch; a refill dispatch minting a proposal) and
    ``"in"`` at its destination (the dispatch serving the parked ask; the
    queue pop consuming the proposal). Both endpoints carry the same
    ``flow_id`` and render as one Perfetto flow arrow in
    :func:`chrome_trace` (``ph: "s"``/``"f"``), bound to the enclosing
    phase span on each side — record endpoints *inside* the span they
    belong to, on the thread that owns it."""
    if not _enabled:
        return
    full_meta = {"flow_id": flow_id, "dir": direction}
    if meta:
        full_meta.update(meta)
    _RECORDER.record("flow", name, trial=trial, meta=full_meta)


def trial_event(name: str, number: int, state: str | None = None) -> None:
    """A trial lifecycle instant (``name``: ``ask``/``tell``). Positional
    args only — the disabled path must not build a kwargs dict per trial."""
    if not _enabled:
        return
    _RECORDER.record(
        "trial", name, trial=number, meta=None if state is None else {"state": state}
    )


def rpc_span(side: str, method: str, ctx: Mapping[str, str] | None):
    """A gRPC op span. ``side`` is ``'client'`` or ``'server'``; ``ctx`` is
    the propagated ``{'t': trace_id, 's': span_id}`` mapping (the client
    mints it and rides it in kwargs beside the op token; the server pops it
    and passes it here so its handler span carries the *client's* trace id
    and parents onto the client's span — one timeline across processes)."""
    if not _enabled:
        return _NULL_SPAN
    if side == "client":
        return _FlightSpan(
            _RECORDER, "rpc.client", "storage.op", None, None, None,
            {"method": method}, ctx["s"] if ctx else None,
        )
    return _FlightSpan(
        _RECORDER, "rpc.server", "storage.op", None,
        ctx["s"] if ctx else None,
        ctx["t"] if ctx else None,
        {"method": method}, None,
    )


def rpc_context() -> dict[str, str]:
    """Mint the per-op propagation context the gRPC client attaches to its
    kwargs (wire key: ``_service.FLIGHT_CTX_KEY``)."""
    return {"t": _RECORDER.trace_id, "s": _RECORDER.new_span_id()}


# ------------------------------------------------------ runtime jit gauges


def _signature_of(value: Any) -> Any:
    """One argument's part of a call signature: a tensor's (or array's)
    shape, dtype and device; a container's parts in order; a string, bool,
    None or enum member by value; any other object (numbers included) by its
    type alone, as a traced argument is keyed by its abstract value."""
    import torch

    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), str(value.dtype), str(value.device))
    if isinstance(value, np.ndarray):
        return ("array", value.shape, str(value.dtype))
    if isinstance(value, (tuple, list)):
        return (type(value).__name__, tuple(_signature_of(v) for v in value))
    if isinstance(value, Mapping):
        return ("mapping", tuple((str(k), _signature_of(v)) for k, v in value.items()))
    if value is None or isinstance(value, (str, bool, enum.Enum)):
        return value
    return ("type", type(value).__qualname__)


def _call_signature(args: tuple, kwargs: Mapping[str, Any]) -> tuple:
    return (
        tuple(_signature_of(a) for a in args),
        tuple(sorted((k, _signature_of(v)) for k, v in kwargs.items())),
    )


def _sync_cuda(args: tuple, kwargs: Mapping[str, Any]) -> None:
    """Wait for the card when the call was handed CUDA tensors, so a
    compile's seconds run to the call's end (only on a new signature)."""
    import torch

    for value in (*args, *kwargs.values()):
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)
            return


#: Per-label compile totals aggregated ACROSS proxies: several wrappers may
#: legitimately share one label (every VectorizedObjective mints its own
#: guarded wrapper under "vectorized.guarded"), and the gauges must report
#: the label's total, not whichever proxy wrote last.
_jit_totals: dict[str, list] = {}
_jit_totals_lock = locksan.lock("flight.jit_totals")


def _note_jit_compile(label: str, seconds: float, retrace: bool) -> None:
    with _jit_totals_lock:
        totals = _jit_totals.setdefault(label, [0, 0.0, 0])
        totals[0] += 1
        totals[1] += seconds
        if retrace:
            totals[2] += 1
        compiles, compile_seconds, retraces = totals
    telemetry.set_gauge("jit.compiles." + label, compiles)
    telemetry.set_gauge("jit.compile_seconds." + label, round(compile_seconds, 6))
    if retraces:
        telemetry.set_gauge("jit.retraces_after_first." + label, retraces)


class _InstrumentedJit:
    """Transparent proxy over a callable that turns new call signatures into
    compile/retrace gauges and flight events.

    The first call of each signature (see :func:`_signature_of`) counts as
    a compile, timed to the call's end (the card is synchronized when the
    call was handed CUDA tensors): eager PyTorch specializes its work per
    shape (allocator pools, kernel selection, the port's kernels' build at
    first use), and a new batch width or history bucket is exactly where a
    loop pays again. A new signature after the first is recorded as a
    retrace. Attribute access forwards to the wrapped callable untouched.
    """

    __slots__ = ("_fn", "_label", "_seen", "_seen_lock")

    def __init__(self, fn: Callable, label: str) -> None:
        self._fn = fn
        self._label = label
        self._seen: set = set()
        self._seen_lock = threading.Lock()

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_fn"), name)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if not _enabled and not telemetry.enabled():
            return self._fn(*args, **kwargs)
        signature = _call_signature(args, kwargs)
        with self._seen_lock:
            new = signature not in self._seen
            if new:
                self._seen.add(signature)
            n_seen = len(self._seen)
        if not new:
            return self._fn(*args, **kwargs)
        t0 = time.monotonic()
        out = self._fn(*args, **kwargs)
        _sync_cuda(args, kwargs)
        seconds = time.monotonic() - t0
        retrace = n_seen > 1
        _note_jit_compile(self._label, seconds, retrace)
        event("jit.compile", self._label, meta={"seconds": round(seconds, 6), "cache_size": n_seen})
        if retrace:
            event("jit.retrace", self._label, meta={"seconds": round(seconds, 6), "cache_size": n_seen})
        return out


def note_kernel_build(source_stem: str, seconds: float) -> None:
    """Record one kernel library's build and load at first use (the port's
    ``nvcc`` step) as a compile under ``kernel.<source stem>``. Free while
    both flight and telemetry are off."""
    if not _enabled and not telemetry.enabled():
        return
    label = "kernel." + source_stem
    _note_jit_compile(label, seconds, False)
    event("jit.compile", label, meta={"seconds": round(seconds, 6), "cache_size": 1})


def jit_totals() -> dict[str, dict[str, float]]:
    """Per-label compile/retrace totals aggregated across every
    :func:`instrument_jit` proxy and kernel build (the aggregates behind the
    ``jit.*`` telemetry gauges, kept here so they survive a
    ``telemetry.reset()`` and accumulate while only flight records).
    Exported by ``telemetry.export_snapshot()``."""
    with _jit_totals_lock:
        return {
            label: {
                "compiles": totals[0],
                "compile_seconds": round(totals[1], 6),
                "retraces_after_first": totals[2],
            }
            for label, totals in _jit_totals.items()
        }


def reset_jit_totals() -> None:
    """Forget the cross-proxy per-label compile totals (tests isolating a
    study's snapshot; the totals are process-lifetime by design)."""
    with _jit_totals_lock:
        _jit_totals.clear()


def instrument_jit(fn: Callable, label: str) -> Callable:
    """Wrap a callable so new call signatures surface as compile/retrace
    gauges and events. Free when both flight and telemetry are disabled (one
    check, straight call-through); idempotent (instrumenting twice returns
    the first proxy)."""
    if isinstance(fn, _InstrumentedJit):
        return fn
    return _InstrumentedJit(fn, label)


def sample_device_gauges() -> None:
    """Sample the card's memory gauges: ``torch.cuda.memory_stats()``'s
    ``allocated_bytes.all.current`` and ``.peak`` as ``hbm.live_bytes`` and
    ``hbm.peak_bytes``, plus one flight ``gauge`` event. Records nothing
    without a card or before CUDA is initialized (as the reference records
    nothing on a CPU backend), and nothing while flight and telemetry are
    off."""
    if not _enabled and not telemetry.enabled():
        return
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    stats = torch.cuda.memory_stats()
    live = stats.get("allocated_bytes.all.current")
    peak = stats.get("allocated_bytes.all.peak", live)
    if live is not None:
        telemetry.set_gauge("hbm.live_bytes", float(live))
    if peak is not None:
        telemetry.set_gauge("hbm.peak_bytes", float(peak))
        event("gauge", "hbm.peak_bytes", meta={"value": float(peak)})


# ----------------------------------------------------------------- exports


def events() -> list[FlightEvent]:
    return _RECORDER.events()


def snapshot() -> list[dict]:
    """The ring's contents as JSON-able dicts, oldest first."""
    return [ev.to_dict() for ev in _RECORDER.events()]


def _trial_slice_ids(
    items: list, trial: int, get_trial, get_span, get_parent
) -> tuple[set[int], set[str]]:
    """The one keep-trial-plus-ancestors traversal both slice flavors share
    (accessor-parameterized so the FlightEvent and rendered-Chrome-dict
    forms cannot drift): ids of items carrying ``trial`` directly, plus the
    transitive closure of parent span ids their chains reference."""
    by_span = {get_span(item): item for item in items if get_span(item) is not None}
    kept_ids = {id(item) for item in items if get_trial(item) == trial}
    ancestor_spans: set[str] = set()
    for item in items:
        if id(item) not in kept_ids:
            continue
        parent = get_parent(item)
        while parent is not None and parent not in ancestor_spans:
            ancestor_spans.add(parent)
            parent_item = by_span.get(parent)
            parent = get_parent(parent_item) if parent_item is not None else None
    return kept_ids, ancestor_spans


def filter_trial(
    event_list: Iterable[FlightEvent], trial: int
) -> list[FlightEvent]:
    """Events attributed to one trial, plus their parent spans (transitive):
    the single-trial postmortem slice behind ``optuna-tpu-torch trace --trial N``.
    An event is kept when it carries ``trial == N`` directly (lifecycle
    instants, per-trial phase spans, trial-tagged device-stat gauges) or
    when a kept event's parent chain references its span id (the batch
    dispatch / RPC span a trial's events hang under). Ring order is
    preserved."""
    evs = list(event_list)
    kept_ids, ancestor_spans = _trial_slice_ids(
        evs,
        trial,
        lambda ev: ev.trial,
        lambda ev: ev.span,
        lambda ev: ev.parent,
    )
    return [
        ev
        for ev in evs
        if id(ev) in kept_ids or (ev.span is not None and ev.span in ancestor_spans)
    ]


def filter_chrome_trace(payload: Mapping, trial: int) -> dict:
    """One-trial slice of an already-rendered Chrome trace dict — the
    ``--endpoint`` flavor of :func:`filter_trial`, for ``optuna-tpu-torch trace
    --trial N --endpoint`` where only ``/trace.json`` output is available.
    Same traversal (:func:`_trial_slice_ids` over ``args.trial`` /
    ``args.span_id`` / ``args.parent_span_id``), plus: metadata records
    (``ph == "M"``) and counter tracks (``ph == "C"`` — gauge events, whose
    rendered form deliberately carries only ``value``, so their trial tag
    is gone by now) are kept as context rather than silently dropped."""
    events = list(payload.get("traceEvents", []))

    def _arg(entry: Mapping, key: str):
        args = entry.get("args")
        return args.get(key) if isinstance(args, Mapping) else None

    kept_ids, ancestors = _trial_slice_ids(
        events,
        trial,
        lambda entry: _arg(entry, "trial"),
        lambda entry: _arg(entry, "span_id"),
        lambda entry: _arg(entry, "parent_span_id"),
    )
    filtered = [
        entry
        for entry in events
        if entry.get("ph") in ("M", "C")
        or id(entry) in kept_ids
        or _arg(entry, "span_id") in ancestors
    ]
    return {**payload, "traceEvents": filtered}


def chrome_trace(event_list: Iterable[FlightEvent] | None = None) -> dict:
    """Render events as Chrome trace-event JSON (the ``traceEvents`` array
    format Perfetto and ``chrome://tracing`` load directly): spans become
    complete ``"X"`` events, instants ``"i"``, gauges ``"C"`` counters.
    Timestamps are wall-clock microseconds, so exports from the processes
    of one study interleave correctly when concatenated."""
    evs = _RECORDER.events() if event_list is None else list(event_list)
    pid = os.getpid()
    trace_events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": f"optuna-tpu-torch[{_RECORDER.trace_id}]"},
        }
    ]
    for ev in evs:
        args: dict[str, Any] = {}
        if ev.trace is not None:
            args["trace_id"] = ev.trace
        if ev.trial is not None:
            args["trial"] = ev.trial
        if ev.span is not None:
            args["span_id"] = ev.span
        if ev.parent is not None:
            args["parent_span_id"] = ev.parent
        if ev.meta:
            args.update(ev.meta)
        entry: dict[str, Any] = {
            "name": ev.name,
            "cat": ev.kind,
            "pid": pid,
            "tid": ev.tid,
            "ts": round(ev.ts * 1e6, 3),
        }
        if ev.dur is not None:
            entry["ph"] = "X"
            entry["dur"] = round(ev.dur * 1e6, 3)
            entry["args"] = args
        elif ev.kind == "gauge":
            entry["ph"] = "C"
            entry["args"] = {"value": args.get("value", 0)}
        elif ev.kind == "flow" and ev.meta and "flow_id" in ev.meta:
            # Perfetto flow arrows: "s" starts an arrow at the enclosing
            # slice of the source endpoint, "f" (binding point "e": the
            # enclosing slice, not the next one) lands it on the
            # destination's slice. Matching ids + category stitch the pair.
            entry["ph"] = "s" if ev.meta.get("dir") == "out" else "f"
            entry["id"] = str(ev.meta["flow_id"])
            if entry["ph"] == "f":
                entry["bp"] = "e"
            entry["args"] = args
        else:
            entry["ph"] = "i"
            entry["s"] = "t"
            entry["args"] = args
        trace_events.append(entry)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": _RECORDER.trace_id, "pid": pid},
    }


# -------------------------------------------------------------- postmortem


def last_postmortem_path() -> str | None:
    return _last_postmortem_path


def postmortem(reason: str, key: str | None = None) -> str | None:
    """Flush the ring's tail (at most :data:`POSTMORTEM_TAIL` events) as one
    bounded JSON file and return its path; None while disabled or when the
    dedupe ``key`` already dumped. Best-effort by contract: a failing dump
    must never mask the failure being dumped. Dumps land in
    ``$OPTUNA_TPU_TORCH_FLIGHT_DUMP_DIR`` (default: the system temp dir)."""
    global _last_postmortem_path
    if not _enabled:
        return None
    if key is not None:
        if key in _postmortem_keys:
            return None
        _postmortem_keys.add(key)
    try:
        tail = _RECORDER.events()[-POSTMORTEM_TAIL:]
        dump_dir = os.environ.get(_DUMP_DIR_ENV) or tempfile.gettempdir()
        path = os.path.join(
            dump_dir,
            f"optuna-tpu-torch-flight-{os.getpid()}-{next(_postmortem_seq)}.json",
        )
        payload = {
            "reason": reason,
            "captured_unix": time.time(),
            "pid": os.getpid(),
            "trace_id": _RECORDER.trace_id,
            "n_events": len(tail),
            "events": [ev.to_dict() for ev in tail],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        _RECORDER.record("postmortem", reason[:200], meta={"path": path})
        _last_postmortem_path = path
        return path
    except Exception:  # best-effort dump while unwinding a real failure: the original error must surface, a broken dump dir must not replace it
        return None


# The environment switch mirrors telemetry's: set before import, recording
# is armed from trial zero.
_env_cap = _env_capacity()
if _env_cap is not None:
    enable(capacity=_env_cap)
del _env_cap
