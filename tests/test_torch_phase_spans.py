"""The port's one phase span (``telemetry.span``) on the batch path, on the
CPU.

A batched TPE run through ``optimize_vectorized`` times each part of each
batch once: the executor's stitched ``ask`` and, inside it, ``ask.fit`` and
``ask.propose`` (the sampler's batch ask, past start-up only), ``ask.create``
and ``ask.suggest``; ``dispatch`` and the read inside it, ``dispatch.wait``;
``tell``. Under a profiler with the flight recorder on, every span gives
one ``optuna_tpu_torch.<phase>`` range on the interval of its flight event
(the profiler stamps Unix-epoch time, as the flight ring does), with its
parent's span id and its batch's tag. Outside a profiler no range is
opened.
"""

from __future__ import annotations

import collections

import pytest
import torch

import optuna_tpu_torch
from optuna_tpu_torch import _tracing, flight, telemetry
from optuna_tpu_torch.distributions import FloatDistribution
from optuna_tpu_torch.parallel import VectorizedObjective, optimize_vectorized
from optuna_tpu_torch.samplers import TPESampler
from tests._torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.ERROR)

SPACE = {"x": FloatDistribution(-5.0, 5.0), "lr": FloatDistribution(1e-3, 1.0, log=True)}
BATCH = 8
N_STARTUP = 8
# The profiler's and the flight ring's readings of one interval.
ALIGN_S = 1e-3


@pytest.fixture(autouse=True)
def _isolated():
    saved = (telemetry.get_registry(), telemetry.enabled(), flight.get_recorder(), flight.enabled())
    yield
    registry, tel_on, recorder, flight_on = saved
    telemetry.enable(registry)
    if not tel_on:
        telemetry.disable()
    flight.enable(recorder)
    if not flight_on:
        flight.disable()


def _objective() -> VectorizedObjective:
    return VectorizedObjective(fn=lambda p: (p["x"] - 1.0) ** 2 + p["lr"], search_space=SPACE)


def _study():
    sampler = TPESampler(seed=0, device="cpu", multivariate=True, constant_liar=True, n_startup_trials=N_STARTUP)
    return optuna_tpu_torch.create_study(sampler=sampler)


def _run(study, n_trials: int) -> None:
    optimize_vectorized(study, _objective(), n_trials=n_trials, batch_size=BATCH, device="cpu")


def test_a_tpe_batch_run_times_each_part_of_each_batch_once():
    telemetry.enable(telemetry.MetricsRegistry())
    _run(_study(), 5 * BATCH)
    hist = telemetry.snapshot()["histograms"]
    counts = {name[len("phase."):]: h["count"] for name, h in hist.items() if name.startswith("phase.")}
    # Batch 0 is the random start-up: the sampler's batch ask fits nothing.
    assert counts == {"ask": 5, "ask.create": 5, "ask.suggest": 5, "dispatch": 5, "dispatch.wait": 5,
                      "tell": 5, "ask.fit": 4, "ask.propose": 4}
    total = {name: hist["phase." + name]["sum"] for name in counts}
    assert sum(total[c] for c in ("ask.fit", "ask.propose", "ask.create", "ask.suggest")) <= total["ask"]
    assert total["dispatch.wait"] <= total["dispatch"]
    for name in counts:
        assert total[name] > 0.0, name


def test_the_per_trial_tpe_ask_splits_into_fit_and_propose():
    telemetry.enable(telemetry.MetricsRegistry())
    study = optuna_tpu_torch.create_study(sampler=TPESampler(seed=0, device="cpu", n_startup_trials=4))
    study.optimize(lambda t: t.suggest_float("x", -5.0, 5.0) ** 2 + t.suggest_float("y", 0.0, 1.0), n_trials=10)
    hist = telemetry.snapshot()["histograms"]
    # Past start-up, each ask samples both dimensions in one relative ask.
    assert hist["phase.ask.fit"]["count"] == hist["phase.ask.propose"]["count"] == 6
    assert hist["phase.ask"]["count"] == 10


def _phase_ranges(prof) -> dict[str, list]:
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("optuna_tpu_torch.") and not e.name().startswith("optuna_tpu_torch.trial."):
            ranges[e.name()[len("optuna_tpu_torch."):]].append((e.start_ns() / 1e9, e.duration_ns() / 1e9))
    return ranges


def test_each_phase_span_is_one_range_on_its_flight_events_interval():
    study = _study()
    _run(study, 2 * BATCH)  # past start-up, so every traced batch fits
    flight.enable(flight.FlightRecorder())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(study, 3 * BATCH)
    events = [e for e in flight.events() if e.kind == "phase"]
    ranges = _phase_ranges(prof)
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[e.name].append(e)
    assert {n: len(v) for n, v in by_name.items()} == {n: len(v) for n, v in ranges.items()}
    assert {n: len(v) for n, v in by_name.items()} == {
        "ask": 6, "ask.fit": 3, "ask.propose": 3, "ask.create": 3, "ask.suggest": 3,
        "dispatch": 3, "dispatch.wait": 3, "tell": 3,
    }
    for name, evs in by_name.items():
        for e, (start, dur) in zip(sorted(evs, key=lambda e: e.ts), sorted(ranges[name])):
            assert abs(start - e.ts) < ALIGN_S, (name, start, e.ts)
            assert abs(dur - e.dur) < ALIGN_S, (name, dur, e.dur)
            assert dur <= e.dur
    # Parents: the innermost span open on the thread; tags: one a batch.
    by_span = {e.span: e for e in events}
    parent_of = {"ask.fit": "ask", "ask.propose": "ask", "ask.create": "ask", "ask.suggest": "ask",
                 "dispatch.wait": "dispatch"}
    for e in events:
        if e.name in parent_of:
            parent = by_span[e.parent]
            assert parent.name == parent_of[e.name]
            assert parent.ts <= e.ts and e.ts + e.dur <= parent.ts + parent.dur
        else:
            assert e.parent is None, e
    tags = collections.defaultdict(list)
    for e in events:
        tags[e.meta["batch"]].append(e.name)
    assert len(tags) == 3
    run_token = next(iter(tags)).split("/")[0]
    assert sorted(tags) == [f"{run_token}/{i}" for i in range(3)]
    for names in tags.values():
        assert sorted(names) == sorted(["ask", "ask", "ask.fit", "ask.propose", "ask.create", "ask.suggest",
                                        "dispatch", "dispatch.wait", "tell"])


def test_no_range_is_opened_outside_a_profiler(monkeypatch, tmp_path):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    telemetry.enable(telemetry.MetricsRegistry())
    flight.enable(flight.FlightRecorder())
    _run(_study(), 2 * BATCH)
    assert opened == []
    assert telemetry.snapshot()["histograms"]["phase.dispatch.wait"]["count"] == 2
    with _tracing.trace(str(tmp_path)):
        with telemetry.span("tell"):
            pass
    assert opened == ["optuna_tpu_torch.tell"]
    # Everything off: the shared null span, whatever its arguments.
    telemetry.disable()
    flight.disable()
    assert telemetry.span("ask") is telemetry.span("dispatch.wait", 3, tag="t/0", observe=False)
    _run(_study(), BATCH)
    assert opened == ["optuna_tpu_torch.tell"]


def test_a_cancelled_span_observes_and_records_nothing():
    telemetry.enable(telemetry.MetricsRegistry())
    flight.enable(flight.FlightRecorder())
    with telemetry.span("ask"):
        with telemetry.span("ask.fit") as fit:
            fit.cancel()
        with telemetry.span("ask.propose"):
            pass
    hist = telemetry.snapshot()["histograms"]
    assert "phase.ask.fit" not in hist and hist["phase.ask.propose"]["count"] == 1
    (ask,) = [e for e in flight.events() if e.name == "ask"]
    assert [(e.name, e.parent) for e in flight.events()] == [("ask.propose", ask.span), ("ask", None)]
