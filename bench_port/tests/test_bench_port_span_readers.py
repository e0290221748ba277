"""The readers of the program's phase spans on a built run record: the
per-batch divisions of the span metrics, ``None`` where the program records
no such span, and the overlap rule of ``idle_untraced_pct.batch``."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.trace import Interval, Op, Trace

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ("ask_fit_ms.batch", "ask_propose_ms.batch", "ask_create_ms.batch", "ask_suggest_ms.batch",
                "dispatch_wait_ms.batch", "tell_ms.batch")


def hist(total: float, count: int) -> dict:
    return {"sum": total, "count": count, "buckets": {}}


# Ten batches, the first a study's start-up: nine fits and proposals.
TELEMETRY = {"histograms": {
    "phase.ask": hist(0.5, 10), "phase.ask.fit": hist(0.09, 9), "phase.ask.propose": hist(0.18, 9),
    "phase.ask.create": hist(0.04, 10), "phase.ask.suggest": hist(0.15, 10),
    "phase.dispatch": hist(6.0, 10), "phase.dispatch.wait": hist(5.5, 10), "phase.tell": hist(0.3, 10),
}}

# A 10 s window; the card busy 1-3 s and 6-7 s, so idle 0-1, 3-6 and 7-10.
# The gap at 3-6 opens under the dispatch (0.5-4), runs through the tell
# (4-4.5) and is under no range from 4.5 to 5; the ask opens at 5. The gap
# at 7-10 has the next ask over 7-8.5, its fit over 7-8, and nothing after
# 8.5. The benchmark's window range is not the program's.
TRACE = Trace(
    ops=[Op("k_a", 1.0, 3.0, 0.9), Op("k_b", 6.0, 7.0, 5.5)],
    ranges=[
        Interval("bench_port.window", 0.0, 10.0),
        Interval("optuna_tpu_torch.dispatch", 0.5, 4.0),
        Interval("optuna_tpu_torch.dispatch.wait", 1.0, 4.0),
        Interval("optuna_tpu_torch.tell", 4.0, 4.5),
        Interval("optuna_tpu_torch.ask", 5.0, 6.5),
        Interval("optuna_tpu_torch.ask", 7.0, 8.5),
        Interval("optuna_tpu_torch.ask.fit", 7.0, 8.0),
    ],
    window=(0.0, 10.0),
)


def record(telemetry=TELEMETRY, trace=TRACE) -> harness.RunRecord:
    return harness.RunRecord(
        workload={}, config={}, traffic={"batch_size": 256}, setup_s=12.5, window_s=10.0, counts={},
        peak_bytes=0, device_name="NVIDIA H100 80GB HBM3", peaks=None, telemetry=telemetry, trace=trace,
    )


def test_the_span_metrics_are_per_batch():
    got = {name: harness.load_reader(name)(record()) for name in SPAN_METRICS}
    assert got == pytest.approx({
        # The fit and the proposal over every ask, start-up batches included.
        "ask_fit_ms.batch": 9.0, "ask_propose_ms.batch": 18.0,
        "ask_create_ms.batch": 4.0, "ask_suggest_ms.batch": 15.0,
        # The wait over every dispatch.
        "dispatch_wait_ms.batch": 550.0, "tell_ms.batch": 30.0,
    })


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_the_program_does_not_record_reads_none(name):
    # The parent's program times ask, dispatch and tell alone.
    old = {"histograms": {k: TELEMETRY["histograms"][k] for k in ("phase.ask", "phase.dispatch")}}
    assert harness.load_reader(name)(record(telemetry=old)) is None
    assert harness.load_reader(name)(record(telemetry=None)) is None
    assert harness.load_reader(name)(record(telemetry={"histograms": {}})) is None


def test_the_tell_is_read_from_the_program_that_has_it():
    old = {"histograms": {"phase.tell": hist(0.3, 10)}}
    assert harness.load_reader("tell_ms.batch")(record(telemetry=old)) == pytest.approx(30.0)


def test_idle_untraced_is_split_by_overlap_not_by_the_range_open_at_a_gap_start():
    read = harness.load_reader("idle_untraced_pct.batch")
    # Idle 7 s: 0-1 under the dispatch from 0.5, 3-6 under the dispatch and
    # the tell to 4.5 and under the ask from 5, 7-10 under the ask to 8.5.
    # Untraced: 0-0.5, 4.5-5 and 8.5-10, 2.5 s.
    assert read(record()) == pytest.approx(100.0 * 2.5 / 7.0)
    # The breakdown's gap-start rule charges the whole 3-6 gap to the wait
    # open at 3 and 7-10 to the fit: it hides the 4.5-5 and 8.5-10 s.
    assert dict(map(tuple, TRACE.gaps_by_range())) == pytest.approx(
        {"window": 1.0, "dispatch.wait": 3.0, "ask.fit": 3.0}
    )


def test_idle_untraced_without_a_trace_or_idle_time_reads_none():
    read = harness.load_reader("idle_untraced_pct.batch")
    assert read(record(trace=None)) is None
    busy = Trace(ops=[Op("k", 0.0, 10.0, 0.0)], ranges=[Interval("bench_port.window", 0.0, 10.0)], window=(0.0, 10.0))
    assert read(record(trace=busy)) is None
    # No program range at all: every idle second is untraced.
    bare = Trace(ops=[Op("k", 2.0, 3.0, 1.0)], ranges=[Interval("bench_port.window", 0.0, 10.0)], window=(0.0, 10.0))
    assert read(record(trace=bare)) == pytest.approx(100.0)


def test_the_new_metrics_are_declared_for_the_batch_cell():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in (*SPAN_METRICS, "idle_untraced_pct.batch"):
        m = entries[name]
        assert m["workloads"] == ["mlp_mnist.b256"] and m["moves"] == "batch_trials_per_s"
        assert (ROOT / "bench_port" / "metrics" / f"{name}.py").is_file()
    assert entries["idle_untraced_pct.batch"]["source"] == "device_trace"
    assert {entries[n]["source"] for n in SPAN_METRICS} == {"program_span"}
