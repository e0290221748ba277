"""The reduction of a ``torch.profiler`` run to what the metrics read:
device operations (with the host moment each was launched) and host ranges
as plain intervals (seconds on the profiler's clock), the measured window,
the device's busy time, its idle gaps by what the host was doing, and the
device time of the operations launched inside a host range.

Host ranges are the ``record_function`` ranges of the program (named
``optuna_tpu_torch.<phase>``) and of the benchmark (``bench_port.<name>``);
a name is reported without its prefix.
"""

from __future__ import annotations

import bisect
import sys
from typing import NamedTuple, Sequence

PREFIXES = ("optuna_tpu_torch.", "bench_port.")
WINDOW = "bench_port.window"


class Interval(NamedTuple):
    name: str
    start: float
    end: float


class Op(NamedTuple):
    """A device operation: where it ran, and when the host launched it."""

    name: str
    start: float
    end: float
    launch: float


def short_name(name: str) -> str:
    for p in PREFIXES:
        if name.startswith(p):
            return name[len(p):]
    return name


def union(intervals: Sequence[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """Device operations and host ranges clipped to one window."""

    def __init__(self, ops: Sequence[Op], ranges: Sequence[Interval], window: tuple[float, float]) -> None:
        w0, w1 = window
        self.window = window
        self.window_s = w1 - w0
        self.ops = [o._replace(start=max(o.start, w0), end=min(o.end, w1)) for o in ops if o.end > w0 and o.start < w1]
        self.ranges = [r for r in ranges if r.end > w0 and r.start < w1]
        self._busy = union([(o.start, o.end) for o in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy)

    def idle_gaps(self) -> list[tuple[float, float]]:
        w0, w1 = self.window
        gaps, cursor = [], w0
        for s, e in self._busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if w1 > cursor:
            gaps.append((cursor, w1))
        return gaps

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations with the most time, summed by name."""
        totals: dict[str, float] = {}
        for o in self.ops:
            totals[o.name] = totals.get(o.name, 0.0) + (o.end - o.start)
        return [[n[:64], t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]

    def gaps_by_range(self, k: int = 10) -> list[list]:
        """Idle time summed by the innermost host range open at each gap's
        start (``window`` where no other range is open); the ``k`` largest."""
        inner = sorted((r for r in self.ranges if r.name != WINDOW), key=lambda r: r.start)
        totals: dict[str, float] = {}
        active: list[Interval] = []
        j = 0
        for gs, ge in self.idle_gaps():
            while j < len(inner) and inner[j].start <= gs:
                active.append(inner[j])
                j += 1
            active = [r for r in active if r.end > gs]
            best = min(active, key=lambda r: r.end - r.start, default=None)
            name = short_name(best.name) if best is not None else short_name(WINDOW)
            totals[name] = totals.get(name, 0.0) + (ge - gs)
        return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]

    def device_s_under(self, range_name: str) -> "float | None":
        """Busy device time of the operations launched inside a host range
        named ``range_name`` (either spelling), wherever they ran: an
        operation that runs after its range has closed still counts, one
        launched before the range opened does not. None where no such range
        ran."""
        spans = union([(r.start, r.end) for r in self.ranges if short_name(r.name) == range_name])
        if not spans:
            return None
        starts = [s for s, _ in spans]
        inside = []
        for o in self.ops:
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and o.launch < spans[i][1]:
                inside.append((o.start, o.end))
        return sum(e - s for s, e in union(inside))


def _is_annotation(event) -> bool:
    """A device-side mirror of a host range (the profiler's GPU user
    annotation), where the event says so."""
    check = getattr(event, "is_user_annotation", None)
    return bool(check()) if check is not None else False


def from_profiler(prof) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` whose
    window is the benchmark's ``bench_port.window`` range. Read from the
    profiler's raw events, which is fast where ``key_averages`` is not."""
    return from_events(prof.profiler.kineto_results.events())


def from_events(events) -> Trace:
    """A :class:`Trace` from the profiler's raw events.

    A device operation's launch is the start of the runtime call that
    launched it (the host-side event of the same CUPTI correlation id); one
    without keeps its own start, and how many do is logged."""
    from torch.autograd import DeviceType

    device, ranges, window = [], [], None
    runtime: dict[int, float] = {}  # CUPTI correlation id -> host start of the launching call
    for e in events:
        name = e.name()
        start, end = e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (start, end)
            if name.startswith(PREFIXES):
                ranges.append(Interval(name, start, end))
            # Host-side calls of the CUDA runtime and driver (``cuda*``,
            # ``cu*``) link to the framework operation that made them; the
            # framework's own operations, whose ids are of another series,
            # link to nothing.
            if e.linked_correlation_id() > 0 or name.startswith("cu"):
                runtime[e.correlation_id()] = start
        elif not name.startswith(PREFIXES) and not _is_annotation(e):
            device.append((name, start, end, e.correlation_id()))
    if window is None:
        raise RuntimeError("the profiler recorded no bench_port.window range")
    ops = [Op(name, start, end, runtime.get(corr, start)) for name, start, end, corr in device]
    unlaunched = sum(corr not in runtime for *_, corr in device)
    print(f"[bench_port] {len(ops) - unlaunched} device ops' launches found, {unlaunched} not",
          file=sys.stderr, flush=True)
    return Trace(ops, ranges, window)
