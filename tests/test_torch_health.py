"""The port's study doctor (``optuna_tpu_torch/health.py``) against the
reference's.

* ``diagnose`` on the same fleet dicts and trial histories gives the same
  findings, for every id in ``HEALTH_CHECKS`` (each case built to fire its
  check, and the union covers the vocabulary).
* ``HealthChaosPlan`` run by either package over a journal file and over a
  sqlite file: the doctor report of each package over that file equals the
  other's (the report's ``generated_unix`` masked; ``now`` and the live
  worker's id are pinned, so ages and findings are exact), and the
  findings are the plan's.
* The reporter's snapshot and the fleet merge round-trip through both
  packages' storages unchanged.
"""

from __future__ import annotations

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu.health as ref_health
import optuna_tpu.telemetry as ref_telemetry
import optuna_tpu_torch
from optuna_tpu.testing import fault_injection as ref_fi
from optuna_tpu_torch import health, telemetry
from optuna_tpu_torch.testing import fault_injection as port_fi
from tests._torch_port import one_torch_thread  # noqa: F401  (fixture)

PKGS = {
    "ref": (optuna_tpu, ref_health, ref_telemetry, ref_fi),
    "port": (optuna_tpu_torch, health, telemetry, port_fi),
}
NOW = 1_700_000_000.0


_HEALTH_SETTINGS = ("_interval_s", "_worker_id", "_clock", "_now")


@pytest.fixture(autouse=True)
def _isolated(one_torch_thread):
    """Each package's telemetry registry and health settings (``enable``'s
    interval, worker id and clocks outlive ``disable``) are restored."""
    saved = [(h.enabled(), t.enabled(), t.get_registry(), {k: getattr(h, k) for k in _HEALTH_SETTINGS})
             for _, h, t, _ in PKGS.values()]
    yield
    for (pkg, h, t, _), (h_on, t_on, registry, settings) in zip(PKGS.values(), saved):
        for key, value in settings.items():
            setattr(h, key, value)
        if not h_on:
            h.disable()
        t.enable(registry)
        if not t_on:
            t.disable()
        pkg.logging.reset_warn_once()


def test_the_vocabularies_equal_the_references():
    assert health.HEALTH_CHECKS == ref_health.HEALTH_CHECKS
    assert health.CHECK_SEVERITIES == ref_health.CHECK_SEVERITIES
    assert set(health._CHECK_FUNCS) == set(health.HEALTH_CHECKS)
    assert port_fi.HEALTH_CHECK_CHAOS_MATRIX == ref_fi.HEALTH_CHECK_CHAOS_MATRIX
    assert (health.WORKER_ATTR_PREFIX, health.HUB_WORKER_ID_SUFFIX, health.SEVERITIES) == (
        ref_health.WORKER_ATTR_PREFIX, ref_health.HUB_WORKER_ID_SUFFIX, ref_health.SEVERITIES,
    )


def _worker(name, *, alive=True, exited=False, age=1.0):
    return {"worker": name, "pid": 1, "seq": 3, "last_seen_unix": NOW - age, "age_s": age,
            "interval_s": 15.0, "exited": exited, "alive": alive}


def _fleet(counters=None, gauges=None, jit=None, workers=None, slo=None, lease=None):
    workers = list(workers or ())
    return {"workers": workers, "n_workers": len(workers), "n_alive": sum(w["alive"] for w in workers),
            "counters": dict(counters or {}), "gauges": dict(gauges or {}), "histograms": {},
            "jit": dict(jit or {}), "slo": dict(slo or {}), "lease": lease}


def _flap_lease(n: int):
    history = [{"owner": "hub-a" if i % 2 == 0 else "hub-b", "epoch": i + 1, "unix": NOW - 100 * (n - i)}
               for i in range(n)]
    return {"owner": history[-1]["owner"], "epoch": n, "ttl_s": 15.0, "granted_unix": NOW - 50,
            "renewed_unix": NOW - 1, "history": history}


def _trials(kind: str, seed: int) -> list:
    """(params, value, state) rows from one seed: a plateau after an early
    best, an improving run, duplicated points, or FAIL-heavy tails."""
    rng = np.random.RandomState(seed)
    xs = rng.uniform(size=40)
    if kind == "plateau":
        return [({"x": float(x)}, 0.0 if i == 0 else 1.0 + float(x), "COMPLETE") for i, x in enumerate(xs)]
    if kind == "improving":
        return [({"x": float(x)}, -float(i), "COMPLETE") for i, x in enumerate(xs)]
    if kind == "duplicates":
        return [({"x": float(xs[i // 2])}, float(i), "COMPLETE") for i in range(24)]
    if kind == "fails":
        return [({"x": float(x)}, None if i % 3 else float(x), "FAIL" if i % 3 else "COMPLETE")
                for i, x in enumerate(xs[:20])]
    return []


CASES = {
    "study.stagnation": (_fleet(), "plateau"),
    "sampler.fallback_storm": (_fleet(counters={"sampler.fallback.relative": 9, "sampler.fallback.independent": 2}),
                               "improving"),
    "sampler.duplicate_proposals": (_fleet(), "duplicates"),
    "executor.quarantine_rate": (_fleet(counters={"executor.quarantine": 5, "heartbeat.reap": 2}), "fails"),
    "executor.dispatch_timeouts": (_fleet(counters={"executor.dispatch_timeout": 3}), ""),
    "jit.retrace_churn": (_fleet(jit={"gp.suggest_fused": {"compiles": 6, "retraces_after_first": 5},
                                      "vectorized.guarded": {"compiles": 1, "retraces_after_first": 0}}), ""),
    "gp.ladder_escalation": (_fleet(gauges={"device.gp.ladder_rung.max": 4.0}), ""),
    "gp.sparse_degraded": (_fleet(gauges={"device.gp.sparse_heldout_err.last": 1.4,
                                          "device.gp.inducing_count.last": 128.0,
                                          "device.gp.sparsity_ratio.last": 0.11}), ""),
    "worker.dead": (_fleet(workers=[_worker("w-live"), _worker("w-dead", alive=False, age=3600.0),
                                    _worker("w-done", alive=False, exited=True, age=9000.0)]), ""),
    "shard.imbalance": (_fleet(gauges={"shard.trials.t0.total": 40.0, "shard.trials.t1.total": 38.0,
                                       "shard.trials.t2.total": 6.0}), ""),
    "service.backpressure": (_fleet(counters={"serve.shed.reject": 3, "serve.shed.independent": 4}), ""),
    "service.ready_queue_starved": (_fleet(counters={"serve.ready_queue.miss": 12, "serve.ready_queue.hit": 2,
                                                     "serve.ready_queue.refill": 5}), ""),
    "service.slo_burn": (_fleet(slo={"serve.ask.latency": {"good": 2, "bad": 30, "burn_long": 90.0,
                                                           "burn_short": 95.0, "estimate_s": 0.2, "burning": True,
                                                           "critical": True, "objective": 0.99, "target_s": 0.005}}),
                         ""),
    "service.hub_dead": (_fleet(workers=[_worker("hub-a-serve", alive=False, age=600.0), _worker("w1")]), ""),
    "checkpoint.stale": (_fleet(counters={"checkpoint.rejected.crc": 2, "checkpoint.fallback": 1}), ""),
    "service.hub_flapping": (_fleet(lease=_flap_lease(4)), ""),
    "service.hub_zombie_fenced": (_fleet(counters={"fleet.fenced_write": 3, "fleet.lease.demote": 1},
                                         lease=_flap_lease(2)), ""),
    "service.partition_suspected": (_fleet(workers=[_worker("hub-a-serve", age=2.0)], lease=_flap_lease(2)), ""),
}


def _frozen(pkg, rows) -> list:
    dist = pkg.distributions.FloatDistribution(0.0, 1.0)
    state = pkg.trial.TrialState
    out = []
    for i, (params, value, s) in enumerate(rows):
        t = pkg.create_trial(params=params, distributions={"x": dist}, value=value, state=getattr(state, s))
        t.number = i
        out.append(t)
    return out


def _diagnose(pkg_name, fleet, rows, **kw):
    pkg, h, _, _ = PKGS[pkg_name]
    directions = [pkg.study.StudyDirection.MINIMIZE]
    return [f.to_dict() for f in h.diagnose(fleet, _frozen(pkg, rows), directions, **kw)]


@pytest.mark.parametrize("check", sorted(CASES))
def test_diagnose_gives_the_references_findings(check):
    fleet, kind = CASES[check]
    rows = _trials(kind, seed=sorted(CASES).index(check))
    port = _diagnose("port", fleet, rows)
    assert port == _diagnose("ref", fleet, rows)
    assert check in {f["check"] for f in port}
    # The same fleet under an override that silences or lowers a threshold.
    kw = {"stagnation_window": 64, "sparse_heldout_err_warn": 2.0, "hub_flap_min_takeovers": 9}
    assert _diagnose("port", fleet, rows, **kw) == _diagnose("ref", fleet, rows, **kw)


def test_the_cases_cover_every_check_and_a_clean_fleet_is_healthy():
    assert set(CASES) == set(health.HEALTH_CHECKS)
    assert _diagnose("port", _fleet(), _trials("improving", 0)) == []
    assert _diagnose("ref", _fleet(), _trials("improving", 0)) == []


def _never_improving(params):
    return (params["x"] - 0.3) ** 2 + 1.0


def _write_chaos_study(pkg_name: str, url_or_storage):
    """``HealthChaosPlan`` in one package over one durable storage: the
    pathological constant history, NaN proposals under GuardedSampler, NaN
    batch slots, the live reporter (id and clocks pinned) publishing at
    every batch, then the dead worker's stale snapshot."""
    pkg, h, t, fi = PKGS[pkg_name]
    from importlib import import_module

    par = import_module(pkg.__name__ + ".parallel")
    res = import_module(pkg.__name__ + ".samplers._resilience")
    plan = fi.health_chaos_plan()
    space = {"x": pkg.distributions.FloatDistribution(0.0, 1.0)}
    t.enable(t.MetricsRegistry())
    h.enable(interval_s=0.0, worker_id="chaos-host-live")
    sampler = res.GuardedSampler(fi.FaultySampler(pkg.samplers.RandomSampler(seed=0),
                                                  nan_at=set(plan.sampler_nan_at), force_relative=True))
    study = pkg.create_study(storage=url_or_storage, study_name="chaos", sampler=sampler)
    fi.PATHOLOGICAL_HISTORY_PLANS[plan.seeded_history_plan].populate(study, space, seed=0)
    obj = fi.FaultyVectorizedObjective(_never_improving, space, nan_at=dict(plan.nan_slots))
    kwargs = {"device": "cpu"} if pkg is optuna_tpu_torch else {}
    par.optimize_vectorized(study, obj, n_trials=plan.n_trials, batch_size=plan.batch_size, **kwargs)
    snap = fi.plant_dead_worker(study, worker_id=plan.dead_worker_id, age_s=plan.dead_worker_age_s)
    h.disable()
    t.disable()
    return plan, snap


def _report(pkg_name, storage, now):
    pkg, h, _, _ = PKGS[pkg_name]
    study_id = storage.get_study_id_from_name("chaos")
    report = h.health_report(storage, study_id, study_name="chaos", now=now)
    return {**report, "generated_unix": None}


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("backend", ["journal", "sqlite"])
def test_a_doctor_report_over_a_file_equals_the_other_packages(writer, backend, tmp_path):
    path = tmp_path / ("chaos.journal" if backend == "journal" else "chaos.db")

    def storage(pkg_name):
        pkg = PKGS[pkg_name][0]
        if backend == "sqlite":
            return pkg.storages.RDBStorage(f"sqlite:///{path}")
        return pkg.storages.JournalStorage(pkg.storages.JournalFileBackend(str(path)))

    plan, planted = _write_chaos_study(writer, storage(writer))
    now = planted["last_seen_unix"] + plan.dead_worker_age_s  # one "now" for both doctors
    ref_report, port_report = _report("ref", storage("ref"), now), _report("port", storage("port"), now)
    assert port_report == ref_report
    assert {f["check"] for f in port_report["findings"]} == set(plan.expected_findings)
    by_check = {f["check"]: f for f in port_report["findings"]}
    assert by_check["executor.quarantine_rate"]["evidence"]["quarantines"] == plan.expected_quarantined
    assert by_check["sampler.fallback_storm"]["evidence"]["fallbacks"] == len(plan.sampler_nan_at)
    workers = {w["worker"]: w for w in port_report["workers"]}
    assert workers["chaos-host-live"]["exited"] and not workers["chaos-host-live"]["alive"]
    assert workers[plan.dead_worker_id]["age_s"] == pytest.approx(plan.dead_worker_age_s)
    assert health.render_text(port_report) == ref_health.render_text(ref_report)


def test_the_reporter_publishes_deltas_since_attach_through_storage():
    telemetry.enable(telemetry.MetricsRegistry())
    telemetry.count("executor.quarantine", 4)  # before attach: not this study's
    clock = iter(float(i) for i in range(100))
    health.enable(interval_s=10.0, worker_id="w0", clock=lambda: next(clock), now=lambda: NOW)
    study = optuna_tpu_torch.create_study(study_name="deltas")
    health.attach(study)
    telemetry.count("executor.quarantine", 2)
    telemetry.set_gauge("device.gp.ladder_rung.max", 3.0)
    telemetry.set_gauge("batch_size", 8.0)  # not a published prefix
    health.maybe_report(study)  # the first call publishes
    health.maybe_report(study)  # inside the interval: rate-limited
    snaps = health.worker_snapshots(study._storage, study._study_id)
    assert list(snaps) == ["w0"]
    snap = snaps["w0"]
    assert snap["counters"] == {"executor.quarantine": 2} and snap["seq"] == 1
    assert snap["gauges"] == {"device.gp.ladder_rung.max": 3.0}
    health.flush(study)
    fleet = health.fleet_snapshot(study._storage, study._study_id, now=NOW)
    ref_fleet = ref_health.fleet_snapshot(study._storage, study._study_id, now=NOW)
    assert fleet == ref_fleet
    assert fleet["workers"][0]["exited"] and fleet["n_alive"] == 0
