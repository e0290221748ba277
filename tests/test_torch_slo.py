"""The port's SLO engine (``optuna_tpu_torch/slo.py``) against the
reference's: the same numpy-seeded observation stream, fed through the
telemetry phase sink of each package on an injected clock, gives equal
reports, exposition lines, text, fleet blocks and verdicts (the report's
``generated_unix`` stamp masked)."""

from __future__ import annotations

import numpy as np
import pytest

import optuna_tpu.slo as ref_slo
import optuna_tpu.telemetry as ref_telemetry
from optuna_tpu.testing import fault_injection as ref_fi
from optuna_tpu_torch import slo, telemetry
from optuna_tpu_torch.testing import fault_injection as port_fi

PAIRS = ((ref_slo, ref_telemetry), (slo, telemetry))


class FakeClock:
    def __init__(self) -> None:
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def _isolated():
    saved = [(s.enabled(), s.get_engine(), t.enabled(), t.get_registry()) for s, t in PAIRS]
    yield
    for (s, t), (on, engine, tel_on, registry) in zip(PAIRS, saved):
        s.disable()
        s._ENGINE = engine
        if on:
            s.enable()
        t.enable(registry)
        if not tel_on:
            t.disable()


PHASES = ("serve.ask", "storage.op", "dispatch", "tell", "scan.chunk", "ask")


def _stream(s, t, seed: int, specs=None, n: int = 400):
    """One seeded observation stream on a fresh clocked engine: latencies
    spread over six decades, a burst of slow ones, the clock advancing
    across burn-window buckets; half through ``observe_phase`` and half
    through spans on the registry's clock."""
    rng = np.random.RandomState(seed)
    clock = FakeClock()
    t.enable(t.MetricsRegistry(clock=clock))
    s.enable(specs, clock=clock)
    for i in range(n):
        phase = PHASES[rng.randint(len(PHASES))]
        seconds = float(10 ** rng.uniform(-6, 1.5)) * (50.0 if 150 <= i < 190 else 1.0)
        if rng.rand() < 0.5:
            t.observe_phase(phase, seconds)
        else:
            with t.span(phase):
                clock.t += seconds
        clock.t += float(rng.exponential(4.0))
    return clock


def _masked(report: dict) -> dict:
    return {**report, "generated_unix": None}


@pytest.mark.parametrize("seed", [0, 3])
def test_the_same_stream_gives_the_references_report(seed):
    for s, t in PAIRS:
        _stream(s, t, seed)
    port, ref = slo.export_report(), ref_slo.export_report()
    assert port["enabled"] is True and len(port["slos"]) == len(slo.SLO_SPECS)
    assert _masked(port) == _masked(ref)
    assert slo.prometheus_lines() == ref_slo.prometheus_lines()
    assert telemetry.render_prometheus() == ref_telemetry.render_prometheus()
    assert slo.render_text(port) == ref_slo.render_text(ref)
    assert slo.cumulative_counts() == ref_slo.cumulative_counts()
    assert slo.worker_snapshot({}) == ref_slo.worker_snapshot({})
    base = {k: (g // 2, b // 2) for k, (g, b) in slo.cumulative_counts().items()}
    assert slo.worker_snapshot(base) == ref_slo.worker_snapshot(base)
    assert slo.burn_score() == ref_slo.burn_score()
    assert slo.burning_slo_ids() == ref_slo.burning_slo_ids()


def test_the_chaos_plans_harsh_spec_burns_as_in_the_reference():
    specs = {}
    for fi, (s, t) in zip((ref_fi, port_fi), PAIRS):
        plan = fi.slo_chaos_plan()
        clock = FakeClock()
        t.enable(t.MetricsRegistry(clock=clock))
        s.enable([plan.harsh_spec()], clock=clock)
        for i in range(plan.burst_asks):  # the overload burst: every ask violates the 1 ns target
            with t.span("serve.ask"):
                clock.t += 1e-4 * (i + 1)
        specs[s] = s.export_report()
    assert _masked(specs[slo]) == _masked(specs[ref_slo])
    (status,) = specs[slo]["slos"]
    assert slo.burning_slo_ids() == ("serve.ask.latency",)
    assert status["burning"] and status["critical"]


def test_the_vocabulary_and_the_sketch_equal_the_references():
    assert slo.SLO_SPECS == ref_slo.SLO_SPECS
    assert [s.__dict__ for s in slo.DEFAULT_SLOS] == [s.__dict__ for s in ref_slo.DEFAULT_SLOS]
    assert port_fi.SLO_CHAOS_MATRIX == ref_fi.SLO_CHAOS_MATRIX
    assert (slo.BURN_WARN, slo.BURN_CRITICAL) == (ref_slo.BURN_WARN, ref_slo.BURN_CRITICAL)
    rng = np.random.RandomState(5)
    xs = rng.lognormal(size=2000)
    for q in (0.5, 0.9, 0.99):
        a, b = slo.P2Quantile(q), ref_slo.P2Quantile(q)
        for x in xs:
            a.observe(float(x))
            b.observe(float(x))
        assert a.value() == b.value()
        assert abs(a.value() - np.quantile(xs, q)) < 0.1 * np.quantile(xs, q)


def test_disabled_engine_reports_not_armed_as_the_reference():
    for s, _ in PAIRS:
        s.disable()
    port, ref = slo.export_report(), ref_slo.export_report()
    assert _masked(port) == _masked(ref) and port["enabled"] is False
    assert slo.render_text(port) == ref_slo.render_text(ref).replace("OPTUNA_TPU_SLO", "OPTUNA_TPU_TORCH_SLO")
    assert slo.prometheus_lines() == ""
    with pytest.raises(ValueError):
        slo.SLOSpec("x", "serve.ask", 1.5, 0.1, 0.99, 60.0)
