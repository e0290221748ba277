"""The port's telemetry exports, flight recorder, locksan, device stats,
tracing and compile-cache modules against the reference (ROADMAP A11).

Each comparison feeds one numpy-seeded script to both packages, with the
clocks injected, and asserts equality: ``render_prometheus`` byte for
byte, ``export_snapshot``, ``histogram_quantile``, the Chrome-trace
structure (the process name, which names the package, masked) and the
``filter_trial`` slices, and locksan's verdicts on scripted acquire orders.
``instrument_jit`` is the port's own rule (a compile a new call signature)
and is checked on its own. The "disabled allocates nothing" checks measure
with ``tracemalloc`` filtered to the port's module files, so other test
workers cannot disturb them.
"""

from __future__ import annotations

import json
import os
import re
import threading
import tracemalloc
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu.device_stats as ref_device_stats
import optuna_tpu.flight as ref_flight
import optuna_tpu.locksan as ref_locksan
import optuna_tpu.slo as ref_slo
import optuna_tpu.telemetry as ref_telemetry
import optuna_tpu_torch
from optuna_tpu_torch import _tracing, device_stats, flight, locksan, slo, telemetry

PACKAGE = Path(optuna_tpu_torch.__file__).resolve().parent

REF = {"telemetry": ref_telemetry, "flight": ref_flight, "slo": ref_slo, "device_stats": ref_device_stats}
PORT = {"telemetry": telemetry, "flight": flight, "slo": slo, "device_stats": device_stats}

# The reference's exposition grammar (tests/test_telemetry.py).
_PROM_LINE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>[^}]*)\})? (?P<value>\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def _isolated():
    """Each test gets fresh registries and recorders in both packages, and
    leaves both as it found them."""
    saved = []
    for mods in (REF, PORT):
        saved.append((mods["telemetry"].get_registry(), mods["telemetry"].enabled(),
                      mods["flight"].get_recorder(), mods["flight"].enabled(), mods["slo"].enabled()))
        mods["flight"].reset_jit_totals()
    yield
    for mods, (registry, tel_on, recorder, flight_on, slo_on) in zip((REF, PORT), saved):
        mods["telemetry"].enable(registry)
        if not tel_on:
            mods["telemetry"].disable()
        mods["flight"].enable(recorder)
        if not flight_on:
            mods["flight"].disable()
        if not slo_on:
            mods["slo"].disable()
        mods["flight"].reset_jit_totals()


NAMES = {
    "counter": ["storage.retry", "sampler.fallback.relative", 'sampler.fallback.w"eird\\fam\nily', "sampler.fallback",
                "serve.shed.reject", "locksan.verdict.lock_order_cycle", "executor.quarantine", "checkpoint.write"],
    "gauge": ["device.gp.ladder_rung.max", "hbm.peak_bytes", "jit.compiles.vectorized.guarded",
              "jit.compile_seconds.gp.suggest_fused", "gauge.with.ünïcode", "device.scan.chunk_fill.last"],
    "histogram": ["device.gp.fit_iterations", "serve.latency"],
    "phase": ["ask", "tell", "dispatch", "scan.chunk", "scan.sync", "storage.op"],
}


def _telemetry_script(tel, seed: int) -> None:
    """One seeded sequence of counts, gauges, observations and phases through
    the module-level entry points of ``tel`` on a fresh clocked registry."""
    rng = np.random.RandomState(seed)
    clock = FakeClock()
    tel.enable(tel.MetricsRegistry(clock=clock))
    for _ in range(200):
        op = rng.randint(7)
        if op == 0:
            tel.count(NAMES["counter"][rng.randint(len(NAMES["counter"]))], int(rng.randint(1, 4)))
        elif op == 1:
            tel.set_gauge(NAMES["gauge"][rng.randint(len(NAMES["gauge"]))], float(rng.normal() * 1e3))
        elif op == 2:
            tel.add_gauge(NAMES["gauge"][rng.randint(len(NAMES["gauge"]))], float(rng.uniform(0, 5)))
        elif op == 3:
            tel.max_gauge(NAMES["gauge"][rng.randint(len(NAMES["gauge"]))], float(rng.uniform(0, 9)))
        elif op == 4:
            tel.observe(NAMES["histogram"][rng.randint(2)], float(10 ** rng.uniform(-6, 3)))
        elif op == 5:
            tel.observe_phase(NAMES["phase"][rng.randint(len(NAMES["phase"]))], float(10 ** rng.uniform(-5, 2)))
        else:
            with tel.span(NAMES["phase"][rng.randint(len(NAMES["phase"]))]):
                clock.t += float(10 ** rng.uniform(-5, 1))


def _parse_exposition(text: str) -> list:
    samples = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        assert m is not None, f"line violates the exposition grammar: {line!r}"
        if m.group("labels"):
            assert not _PROM_LABEL.sub("", m.group("labels")).strip(", "), line
        samples.append((m.group("name"), m.group("labels"), float(m.group("value"))))
    return samples


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_exports_equal_the_references_on_one_script(seed):
    for mods in (REF, PORT):
        _telemetry_script(mods["telemetry"], seed)
    ref_text, port_text = ref_telemetry.render_prometheus(), telemetry.render_prometheus()
    assert port_text == ref_text
    assert len(_parse_exposition(port_text)) > 50
    assert telemetry.export_snapshot() == ref_telemetry.export_snapshot()
    assert telemetry.phase_totals() == ref_telemetry.phase_totals()
    snap = telemetry.snapshot()
    for name, hist in snap["histograms"].items():
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert telemetry.histogram_quantile(hist, q) == ref_telemetry.histogram_quantile(hist, q), (name, q)
    assert list(telemetry.iter_counter_families()) == list(ref_telemetry.iter_counter_families())
    assert telemetry.PHASES.keys() == ref_telemetry.PHASES.keys()
    assert telemetry.COUNTERS == ref_telemetry.COUNTERS
    assert telemetry.trace_name("scan.chunk") == "optuna_tpu_torch.scan.chunk"


def test_export_snapshot_carries_the_jit_totals_of_both_rules():
    telemetry.enable(telemetry.MetricsRegistry())
    ref_telemetry.enable(ref_telemetry.MetricsRegistry())
    for fl in (ref_flight, flight):
        fl._note_jit_compile("gp.suggest_fused", 1.5, False)
        fl._note_jit_compile("gp.suggest_fused", 0.25, True)
    assert telemetry.export_snapshot() == ref_telemetry.export_snapshot()
    assert telemetry.export_snapshot()["jit"] == {
        "gp.suggest_fused": {"compiles": 2, "compile_seconds": 1.75, "retraces_after_first": 1}
    }


def _flight_script(fl, tel) -> None:
    """Spans, trial instants, containment through the counter sink, flows,
    gauges and an RPC pair on a clocked recorder with a fixed trace id."""
    clock = FakeClock(10.0)
    fl.enable(fl.FlightRecorder(capacity=64, clock=clock, epoch=1000.0, trace_id="feedfacecafebeef"))
    tel.disable()
    for trial in range(4):
        with fl.span("ask"):
            clock.t += 0.01
        fl.trial_event("ask", trial)
        with fl.span("dispatch", trial):
            clock.t += 0.5
            if trial == 2:
                tel.count("executor.quarantine")
                tel.count("sampler.fallback.relative", 2, meta={"phase": "relative"})
        with fl.span("tell", trial):
            clock.t += 0.02
        fl.trial_event("tell", trial, "FAIL" if trial == 2 else "COMPLETE")
    flow_id = fl.new_flow_id()
    with fl.span("scan.chunk"):
        fl.flow("serve.coalesce", flow_id, "out", trial=1)
        clock.t += 1.0
    with fl.span("scan.sync"):
        fl.flow("serve.coalesce", flow_id, "in", trial=3)
        fl.event("gauge", "device.gp.sparse_heldout_err", trial=3, meta={"value": 0.75})
        clock.t += 0.1
    ctx = fl.rpc_context()
    with fl.rpc_span("client", "set_trial_state_values", ctx):
        with fl.rpc_span("server", "set_trial_state_values", ctx):
            clock.t += 0.003


def _masked(trace: dict) -> dict:
    out = json.loads(json.dumps(trace))
    out["traceEvents"][0]["args"]["name"] = "<process>"
    return out


def test_the_chrome_trace_and_its_trial_slices_equal_the_references():
    for mods in (REF, PORT):
        _flight_script(mods["flight"], mods["telemetry"])
    ref_trace, port_trace = ref_flight.chrome_trace(), flight.chrome_trace()
    assert port_trace["traceEvents"][0]["args"]["name"].startswith("optuna-tpu-torch[")
    assert _masked(port_trace) == _masked(ref_trace)
    assert [e["ph"] for e in port_trace["traceEvents"]].count("s") == 1
    assert flight.snapshot() == ref_flight.snapshot()
    for trial in range(4):
        port_slice = [e.to_dict() for e in flight.filter_trial(flight.events(), trial)]
        assert port_slice == [e.to_dict() for e in ref_flight.filter_trial(ref_flight.events(), trial)]
        assert port_slice
        assert _masked(flight.filter_chrome_trace(port_trace, trial)) == _masked(
            ref_flight.filter_chrome_trace(ref_trace, trial)
        )
    assert flight.EVENT_KINDS.keys() == ref_flight.EVENT_KINDS.keys()
    with pytest.raises(ValueError, match="unknown flight event kind"):
        flight.event("nope", "x")


def test_a_postmortem_lands_in_the_dump_dir_once_per_key(tmp_path, monkeypatch):
    monkeypatch.setenv("OPTUNA_TPU_TORCH_FLIGHT_DUMP_DIR", str(tmp_path))
    flight.enable(flight.FlightRecorder(capacity=8))
    for i in range(20):
        flight.event("trial", "ask", trial=i)
    path = flight.postmortem("batch aborted: boom", key="k")
    assert path is not None and Path(path).parent == tmp_path
    assert flight.postmortem("again", key="k") is None
    payload = json.loads(Path(path).read_text())
    assert payload["reason"] == "batch aborted: boom" and payload["n_events"] == 8
    assert flight.last_postmortem_path() == path


def _locksan_script(ls) -> dict:
    """A -> B on one thread, then B -> A on another (a potential deadlock),
    then a declared blocking op under a held lock."""
    ls.enable()
    a, b = ls.lock("suggest.shed"), ls.lock("suggest.coalesce")
    with a:
        with b:
            pass

    def reverse():
        with b:
            with a:
                pass

    t = threading.Thread(target=reverse, name="locksan-reverse")
    t.start()
    t.join()
    with a:
        with ls.blocking("storage.op"):
            pass
    report = ls.report()
    ls.disable()
    ls.reset()
    return report


def test_locksan_gives_the_references_verdicts_on_scripted_orders():
    ref_tel, port_tel = ref_telemetry.MetricsRegistry(), telemetry.MetricsRegistry()
    ref_telemetry.enable(ref_tel)
    telemetry.enable(port_tel)
    ref_report, port_report = _locksan_script(ref_locksan), _locksan_script(locksan)
    assert port_report == ref_report
    assert {v["kind"] for v in port_report["verdicts"]} == {"lock_order_cycle", "held_across_blocking"}
    assert port_tel.snapshot()["counters"] == ref_tel.snapshot()["counters"]
    assert locksan.LOCK_NAMES == ref_locksan.LOCK_NAMES
    assert type(locksan.lock("telemetry.registry")) is type(threading.Lock())


def test_instrument_jit_counts_a_compile_per_new_signature():
    telemetry.enable(telemetry.MetricsRegistry())
    flight.enable(flight.FlightRecorder())
    calls = []

    def program(x, n, *, mode="a"):
        calls.append(1)
        return x * n

    proxy = flight.instrument_jit(program, "test.program")
    assert flight.instrument_jit(proxy, "other") is proxy
    proxy(torch.zeros(4), 3)
    proxy(torch.ones(4), 5)  # same shapes and types: no compile
    proxy(torch.zeros(8), 3)  # a new width: a retrace
    proxy(torch.zeros(8, dtype=torch.float64), 3)  # a new dtype: a retrace
    proxy(torch.zeros(8), 3, mode="b")  # a new static argument: a retrace
    proxy(np.zeros(3), 2.5)
    assert len(calls) == 6
    totals = flight.jit_totals()["test.program"]
    assert (totals["compiles"], totals["retraces_after_first"]) == (5, 4)
    gauges = telemetry.snapshot()["gauges"]
    assert gauges["jit.compiles.test.program"] == 5 and gauges["jit.retraces_after_first.test.program"] == 4
    kinds = [e.kind for e in flight.events() if e.name == "test.program"]
    assert kinds.count("jit.compile") == 5 and kinds.count("jit.retrace") == 4
    text = telemetry.render_prometheus()
    assert 'optuna_tpu_jit_compiles{label="test.program"} 5' in text
    # Off: a straight call-through that records nothing.
    telemetry.disable()
    flight.disable()
    proxy(torch.zeros(16), 1)
    assert flight.jit_totals()["test.program"]["compiles"] == 5


def test_a_kernel_build_is_recorded_as_a_compile_under_its_source_stem():
    telemetry.enable(telemetry.MetricsRegistry())
    flight.note_kernel_build("matern52_gram", 4.5)
    assert flight.jit_totals()["kernel.matern52_gram"] == {
        "compiles": 1, "compile_seconds": 4.5, "retraces_after_first": 0,
    }
    telemetry.disable()
    flight.reset_jit_totals()
    flight.note_kernel_build("matern52_gram", 4.5)  # both off: nothing
    assert flight.jit_totals() == {}


def test_device_stats_harvest_publishes_as_the_reference():
    stats = {"gp.ladder_rung": 2, "gp.fit_iterations": 24, "gp.best_acq": -1.5, "gp.sparse_heldout_err": 0.3}
    for mods in (REF, PORT):
        mods["telemetry"].enable(mods["telemetry"].MetricsRegistry())
        mods["flight"].enable(mods["flight"].FlightRecorder(clock=FakeClock(), epoch=0.0, trace_id="t"))
        mods["device_stats"].harvest(stats, trial=7)
        mods["device_stats"].harvest({"gp.ladder_rung": 1, "gp.fit_iterations": 6})
    assert telemetry.snapshot() == ref_telemetry.snapshot()
    assert flight.snapshot() == ref_flight.snapshot()
    assert device_stats.gauge_name("gp.ladder_rung") == ref_device_stats.gauge_name("gp.ladder_rung")
    assert device_stats.DEVICE_STATS == ref_device_stats.DEVICE_STATS
    assert device_stats.enabled()
    with pytest.raises(ValueError, match="unknown device stat"):
        device_stats.harvest({"gp.nope": 1})


def test_sample_device_gauges_records_nothing_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the card's gauges are checked by chip_smoke.py")
    telemetry.enable(telemetry.MetricsRegistry())
    flight.enable(flight.FlightRecorder())
    flight.sample_device_gauges()
    assert telemetry.snapshot()["gauges"] == {} and flight.events() == []


def _port_allocations(fn, n: int = 10_000) -> int:
    """Bytes still allocated by the port's module files after ``n`` calls."""
    filters = [tracemalloc.Filter(True, str(PACKAGE / "*"))]
    fn()  # warm up lazies
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(filters)
        for _ in range(n):
            fn()
        after = tracemalloc.take_snapshot().filter_traces(filters)
    finally:
        tracemalloc.stop()
    return sum(stat.size_diff for stat in after.compare_to(before, "filename") if stat.size_diff > 0)


def test_the_disabled_hooks_allocate_nothing():
    from optuna_tpu_torch import autopilot, health

    telemetry.disable()
    flight.disable()
    slo.disable()
    health.disable()
    study = optuna_tpu_torch.create_study()

    def boundary():
        with telemetry.span("ask"), flight.span("ask"), _tracing.annotate("optuna_tpu_torch.trial.%d", 3):
            pass
        telemetry.count("executor.quarantine")
        flight.trial_event("tell", 3, "COMPLETE")
        device_stats.harvest({"gp.ladder_rung": 1})
        health.maybe_report(study)
        autopilot.maybe_step(study)
        with locksan.blocking("storage.op"):
            pass

    assert _port_allocations(boundary) == 0


def _get(url: str) -> tuple[int, str, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=10) as response:
            return response.status, response.headers["Content-Type"], response.read()
    except urllib.error.HTTPError as err:
        return err.code, "", b""


def test_serve_metrics_serves_every_endpoint_on_loopback():
    from optuna_tpu_torch import health

    telemetry.enable(telemetry.MetricsRegistry())
    flight.enable(flight.FlightRecorder())
    telemetry.count("storage.retry", 2)
    study = optuna_tpu_torch.create_study(study_name="served")
    for source in (None, lambda: health.storage_health_reports(study._storage)):
        server = telemetry.serve_metrics(0, host="127.0.0.1", health_source=source)
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            status, ctype, body = _get(base + "/metrics")
            assert status == 200 and ctype.startswith("text/plain")
            assert body.decode() == telemetry.render_prometheus()
            assert "optuna_tpu_storage_retry_total 2" in body.decode()
            assert json.loads(_get(base + "/metrics.json")[2])["counters"] == {"storage.retry": 2}
            assert json.loads(_get(base + "/trace.json")[2])["traceEvents"][0]["ph"] == "M"
            assert json.loads(_get(base + "/slo.json")[2])["enabled"] is False
            assert "autopilots" in json.loads(_get(base + "/autopilot.json")[2])
            served = json.loads(_get(base + "/health.json")[2])
            if source is None:
                assert served["enabled"] is False and served["reports"] == []
            else:
                assert [r["study"] for r in served["reports"]] == ["served"]
            assert _get(base + "/nope")[0] == 404
        finally:
            server.shutdown()
            server.server_close()
    assert not [t for t in threading.enumerate() if t.name == "optuna-tpu-torch-metrics" and t.is_alive()]


def test_tracing_annotates_only_while_a_profiler_runs(tmp_path, monkeypatch):
    assert _tracing.annotate("x") is _tracing.annotate("optuna_tpu_torch.trial.%d", 3)
    with _tracing.trace(str(tmp_path)) as prof:
        assert _tracing.is_tracing()
        with _tracing.annotate("optuna_tpu_torch.trial.%d", 7):
            torch.ones(3).sum()
        with _tracing.annotate(lambda: "lazy.name"), _tracing.annotate(("fmt.%s", "tuple")):
            pass
    assert not _tracing.is_tracing()
    names = {e.key for e in prof.key_averages()}
    assert {"optuna_tpu_torch.trial.7", "lazy.name", "fmt.tuple"} <= names
    trace = json.loads(Path(_tracing.last_trace_path).read_text())
    assert any(e.get("name") == "optuna_tpu_torch.trial.7" for e in trace["traceEvents"])
    # The environment switch: one optimize run traced into the directory.
    logdir = tmp_path / "env"
    monkeypatch.setenv("OPTUNA_TPU_TORCH_TRACE", str(logdir))
    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=3)
    (written,) = logdir.glob("*.pt.trace.json")
    events = {e.get("name") for e in json.loads(written.read_text())["traceEvents"]}
    assert {"optuna_tpu_torch.ask", "optuna_tpu_torch.tell", "optuna_tpu_torch.trial.2"} <= events


def test_the_device_policy_keeps_a_passed_device_and_routes_by_latency(monkeypatch):
    from optuna_tpu_torch import _device_policy

    assert _device_policy.small_kernel_device("cpu") == torch.device("cpu")
    _device_policy._routed_device.cache_clear()
    monkeypatch.setattr(_device_policy, "default_dispatch_latency_s", lambda: 0.5)
    assert _device_policy.small_kernel_device() == torch.device("cpu")
    _device_policy._routed_device.cache_clear()
    if not torch.cuda.is_available():
        monkeypatch.setattr(_device_policy, "default_dispatch_latency_s", lambda: 1e-4)
        with pytest.raises(RuntimeError, match="no GPU"):
            _device_policy.small_kernel_device()
    _device_policy._routed_device.cache_clear()


def test_the_compile_cache_switches_set_the_kernels_build_dir(tmp_path, monkeypatch):
    from optuna_tpu_torch.ops.kernels import _nvcc
    from optuna_tpu_torch.utils import _compile_cache

    default = _nvcc.BUILD_DIR
    assert default == Path(_nvcc.__file__).resolve().parent / "_build"
    try:
        for env, check in (
            ({"OPTUNA_TPU_TORCH_CACHE_DIR": str(tmp_path / "cache")}, lambda d: d == tmp_path / "cache"),
            ({"OPTUNA_TPU_TORCH_NO_COMPILE_CACHE": "1"}, lambda d: d != default and d.is_dir()),
            ({}, lambda d: d == default),
        ):
            monkeypatch.delenv("OPTUNA_TPU_TORCH_CACHE_DIR", raising=False)
            monkeypatch.delenv("OPTUNA_TPU_TORCH_NO_COMPILE_CACHE", raising=False)
            for key, value in env.items():
                monkeypatch.setenv(key, value)
            _nvcc.BUILD_DIR = default
            monkeypatch.setattr(_compile_cache, "_done", False)
            _compile_cache.ensure_compile_cache()
            assert check(_nvcc.BUILD_DIR), (env, _nvcc.BUILD_DIR)
            assert _nvcc.library_path("matern52_gram.cu").parent == _nvcc.BUILD_DIR
    finally:
        _nvcc.BUILD_DIR = default


def test_reset_warn_once_rearms_the_one_shot_warnings(caplog):
    from optuna_tpu_torch.logging import get_logger, reset_warn_once, warn_once

    logger = get_logger("optuna_tpu_torch.test_observability")
    assert warn_once(logger, "k", "first") and not warn_once(logger, "k", "second")
    reset_warn_once()
    assert warn_once(logger, "k", "third")
    assert optuna_tpu.logging.reset_warn_once is not None  # the reference names it too
