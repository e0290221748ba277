"""The port's autopilot (``optuna_tpu_torch/autopilot.py``) against the
reference's.

* ``AutopilotChaosPlan`` through ``optimize_vectorized`` in both packages:
  in ``mode="act"`` exactly the plan's actions fire, once each, with the
  reference's decisions, states and evidence (the ``decided_unix`` stamps
  masked) and the reference's trial states (and points, up to the restart's
  reseed from fresh entropy); ``sampler.restart`` rolls back; no
  trial is left RUNNING. The ``observe`` twin records the act run's
  decisions, mutates nothing and is identical trial for trial to the off
  twin.
* ``gp.densify``'s ladder on scan control dicts equals the reference's.
* A small CPU ``optimize_scan`` past ``n_exact_max`` doubles ``n_inducing``
  at the first SGPR sync, re-seeds the inducing set at the new power-of-two
  capacity, and then follows the rollback verdict that the reference's
  autopilot gives on the same history and the same held-out errors.
* The executor's two actuators and their undos.
"""

from __future__ import annotations

import pytest
import torch

import optuna_tpu
import optuna_tpu.autopilot as ref_autopilot
import optuna_tpu.flight as ref_flight
import optuna_tpu.telemetry as ref_telemetry
import optuna_tpu_torch
from optuna_tpu.testing import fault_injection as ref_fi
from optuna_tpu_torch import autopilot, flight, health, telemetry
from optuna_tpu_torch.testing import fault_injection as port_fi
from tests._torch_port import one_torch_thread  # noqa: F401  (fixture)

PKGS = {
    "ref": (optuna_tpu, ref_autopilot, ref_telemetry, ref_flight, ref_fi),
    "port": (optuna_tpu_torch, autopilot, telemetry, flight, port_fi),
}


@pytest.fixture(autouse=True)
def _isolated(one_torch_thread):
    saved = [(a.enabled(), t.enabled(), t.get_registry(), f.enabled(), f.get_recorder())
             for _, a, t, f, _ in PKGS.values()]
    yield
    for (pkg, a, t, f, _), (a_on, t_on, registry, f_on, recorder) in zip(PKGS.values(), saved):
        if not a_on:
            a.disable()
        t.enable(registry)
        if not t_on:
            t.disable()
        f.enable(recorder)
        if not f_on:
            f.disable()
        f.reset_jit_totals()
        pkg.logging.reset_warn_once()


def test_the_vocabularies_equal_the_references():
    assert autopilot.ACTIONS == ref_autopilot.ACTIONS
    assert autopilot.ACTION_TRIGGERS == ref_autopilot.ACTION_TRIGGERS
    assert autopilot.MODES == ref_autopilot.MODES
    assert autopilot.ACTION_ATTR_PREFIX == ref_autopilot.ACTION_ATTR_PREFIX
    assert port_fi.AUTOPILOT_CHAOS_MATRIX == ref_fi.AUTOPILOT_CHAOS_MATRIX
    assert set(port_fi.AUTOPILOT_CHAOS_MATRIX) == set(autopilot.ACTIONS)
    assert {c for checks in autopilot.ACTION_TRIGGERS.values() for c in checks} <= set(health.HEALTH_CHECKS)
    assert port_fi.autopilot_chaos_plan() == port_fi.AutopilotChaosPlan()


def _never_improving(params):
    return (params["x"] - 0.3) ** 2 + 1.0


def _run_twin(pkg_name: str, mode: str | None):
    """``AutopilotChaosPlan``'s study in one package: a constant seeded
    history, NaN proposals under GuardedSampler, NaN batch slots; ``mode``
    None is the autopilot off."""
    pkg, ap, tel, fl, fi = PKGS[pkg_name]
    from importlib import import_module

    par = import_module(pkg.__name__ + ".parallel")
    res = import_module(pkg.__name__ + ".samplers._resilience")
    plan = fi.autopilot_chaos_plan()
    tel.enable(tel.MetricsRegistry())
    fl.enable(fl.FlightRecorder())
    fl.reset_jit_totals()
    pkg.logging.reset_warn_once()
    space = {"x": pkg.distributions.FloatDistribution(0.0, 1.0)}
    sampler = res.GuardedSampler(fi.FaultySampler(pkg.samplers.RandomSampler(seed=0),
                                                  nan_at=set(plan.sampler_nan_at), force_relative=True))
    study = pkg.create_study(sampler=sampler)
    fi.PATHOLOGICAL_HISTORY_PLANS[plan.seeded_history_plan].populate(study, space, seed=0)
    obj = fi.FaultyVectorizedObjective(_never_improving, space, nan_at=dict(plan.nan_slots))
    kwargs = {} if mode is None else {"autopilot": ap.AutopilotPolicy(
        mode=mode, interval_s=0.0, cooldown_s=plan.cooldown_s, budget=plan.budget,
        rollback_after=plan.rollback_after, pin_trials=plan.pin_trials,
        overrides={"stagnation_window": plan.stagnation_window},
    )}
    if pkg is optuna_tpu_torch:
        kwargs["device"] = "cpu"
    par.optimize_vectorized(study, obj, n_trials=plan.n_trials, batch_size=plan.batch_size, **kwargs)
    events = [e.name for e in fl.events() if e.kind == "containment" and e.name.startswith("autopilot.action.")]
    fl.disable()
    return plan, study, tel.snapshot(), events


def _fingerprint(study) -> list[tuple]:
    return [(t.number, t.state.name, tuple(sorted(t.params.items())), tuple(t.values or ()))
            for t in sorted(study.get_trials(deepcopy=False), key=lambda t: t.number)]


def _records(study) -> list[dict]:
    report = study.__dict__["_autopilot"].report()
    return [{**r, "decided_unix": None, "cooldown_remaining_s": None} for r in report["actions"]]


def test_act_mode_fires_the_plans_actions_once_as_the_reference():
    plan, study, snap, events = _run_twin("port", "act")
    _, ref_study, ref_snap, ref_events = _run_twin("ref", "act")
    records = _records(study)
    assert records == _records(ref_study)
    # sampler.restart reseeds the sampler from fresh entropy in both packages,
    # so the points agree up to it (the seeded history and the first batch)
    # and the trial states agree throughout.
    n_before = len(study.trials) - plan.n_trials + plan.batch_size
    assert _fingerprint(study)[:n_before] == _fingerprint(ref_study)[:n_before]
    assert [f[:2] for f in _fingerprint(study)] == [f[:2] for f in _fingerprint(ref_study)]
    assert sorted(r["action"] for r in records) == sorted(plan.expected_actions)
    states = {r["action"]: r["state"] for r in records}
    assert states == {"sampler.restart": "rolled_back", "sampler.pin_independent": "held",
                      "executor.tighten_regrowth": "held"}
    assert states[plan.rollback_action] == "rolled_back"
    counters = snap["counters"]
    for action in plan.expected_actions:
        assert counters["autopilot.action." + action] == 1
    assert (counters["autopilot.action.rollback"], counters["autopilot.action.held"]) == (1, 2)
    assert {k: v for k, v in counters.items() if k.startswith("autopilot.")} == {
        k: v for k, v in ref_snap["counters"].items() if k.startswith("autopilot.")
    }
    assert events == ref_events and len(events) == 6
    mirrored = {k: v for k, v in study.system_attrs.items() if k.startswith(autopilot.ACTION_ATTR_PREFIX)}
    assert {v["action"]: v["state"] for v in mirrored.values()} == states
    trial_states = [t.state.name for t in study.trials]
    assert trial_states.count("RUNNING") == 0 and trial_states.count("FAIL") == plan.expected_quarantined
    assert study.sampler.sampler.suggests == plan.batch_size  # the pin stopped the storm


def test_the_observe_twin_records_the_act_decisions_and_equals_the_off_twin():
    _, act, _, _ = _run_twin("port", "act")
    plan, observe, observe_snap, _ = _run_twin("port", "observe")
    _, off, _, _ = _run_twin("port", None)
    records = _records(observe)
    assert {(r["action"], r["check"]) for r in records} == {(r["action"], r["check"]) for r in _records(act)}
    assert {r["state"] for r in records} == {"observed"} and not any(r["undo_pending"] for r in records)
    assert not any(k.startswith(autopilot.ACTION_ATTR_PREFIX) for k in observe.system_attrs)
    assert observe.sampler.pinned_remaining == 0
    assert observe.sampler.sampler.suggests == off.sampler.sampler.suggests
    for action in plan.expected_actions:
        assert observe_snap["counters"]["autopilot.action." + action] == 1
    assert _fingerprint(observe) == _fingerprint(off)
    assert "_autopilot" not in off.__dict__


@pytest.mark.parametrize("m", [1, 8, 96, 128, 256, 300, 511, 512, 1024])
def test_the_densify_ladder_on_scan_control_dicts_equals_the_references(m, monkeypatch):
    import optuna_tpu.gp.sparse as ref_sparse
    import optuna_tpu_torch.gp.sparse as port_sparse

    assert port_sparse.N_INDUCING_MAX == ref_sparse.N_INDUCING_MAX
    for cap in (port_sparse.N_INDUCING_MAX, 256):
        monkeypatch.setattr(port_sparse, "N_INDUCING_MAX", cap)
        monkeypatch.setattr(ref_sparse, "N_INDUCING_MAX", cap)
        port_ctl, ref_ctl = {"n_exact_max": 1024, "n_inducing": m}, {"n_exact_max": 1024, "n_inducing": m}
        undo_port, undo_ref = autopilot._densify(port_ctl), ref_autopilot._densify(ref_ctl)
        assert port_ctl == ref_ctl
        second_port, second_ref = autopilot._densify(port_ctl), ref_autopilot._densify(ref_ctl)
        assert port_ctl == ref_ctl
        second_port(), second_ref()
        undo_port(), undo_ref()
        assert port_ctl == ref_ctl == {"n_exact_max": 1024, "n_inducing": m}


def test_densify_reaches_the_gp_sampler_through_the_guard():
    from optuna_tpu_torch.samplers import GPSampler
    from optuna_tpu_torch.samplers._resilience import GuardedSampler

    study = optuna_tpu_torch.create_study(sampler=GuardedSampler(GPSampler(device="cpu", n_inducing=64)))
    pilot = autopilot.Autopilot(study, autopilot.AutopilotPolicy(mode="act"))
    target = pilot._resolve_target("gp.densify")
    assert target is study.sampler
    undo = autopilot._densify(target)
    assert study.sampler.sampler._sparse_limits()[1] == 128
    undo()
    assert study.sampler.sampler._sparse_limits()[1] == 64


def _scan_objective():
    from optuna_tpu_torch.models.benchmarks import hartmann6_torch
    from optuna_tpu_torch.parallel import VectorizedObjective

    dist = optuna_tpu_torch.distributions.FloatDistribution(0.0, 1.0)
    return VectorizedObjective(hartmann6_torch, {f"x{i}": dist for i in range(6)})


def test_a_cpu_scan_densifies_and_follows_the_references_rollback_verdict(monkeypatch):
    """Chunks of 8 past ``n_exact_max=12`` with ``n_inducing=16``: the first
    SGPR sync decides ``gp.densify`` (m 16 -> 32); the chunk dispatched
    after it re-seeds at capacity 32; ``rollback_after=16`` gives the
    verdict at the sync two chunks later; the chunk after that runs at the
    verdict's capacity. The reference's autopilot, stepped on the same
    trials with the same held-out errors, gives the same verdict."""
    from optuna_tpu_torch.parallel import scan_loop

    seeded: list[tuple[int, int]] = []
    chunk = {"idx": -1}
    real_draws, real_seed = scan_loop._chunk_draws, scan_loop._seed_inducing_program

    def draws(key_seed, chunk_idx, *a, **k):
        chunk["idx"] = chunk_idx
        return real_draws(key_seed, chunk_idx, *a, **k)

    def seed_program(m_pad):
        seeded.append((chunk["idx"] + 1, m_pad))  # seeded just before the chunk draws
        return real_seed(m_pad)

    monkeypatch.setattr(scan_loop, "_chunk_draws", draws)
    monkeypatch.setattr(scan_loop, "_seed_inducing_program", seed_program)
    errors: list[float] = []
    real_publish = scan_loop._publish_chunk

    def publish(stats):
        if "gp.sparse_heldout_err" in stats:
            errors.append(float(stats["gp.sparse_heldout_err"]))
        real_publish(stats)

    monkeypatch.setattr(scan_loop, "_publish_chunk", publish)
    telemetry.enable(telemetry.MetricsRegistry())
    policy = autopilot.AutopilotPolicy(mode="act", interval_s=0.0, overrides={"sparse_heldout_err_warn": 0.0},
                                       rollback_after=16, cooldown_s=3600.0,
                                       clock=lambda: 0.0, now=lambda: 0.0)
    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    autopilot.attach(study, config=policy)
    study.optimize_scan(_scan_objective(), 48, sync_every=8, n_startup_trials=8, seed=0, device="cpu",
                        n_exact_max=12, n_inducing=16)
    records = [r for r in study.__dict__["_autopilot"].report()["actions"] if r["action"] == "gp.densify"]
    assert len(records) == 1
    (record,) = records
    verdict = record["state"]
    assert verdict in ("held", "rolled_back")
    # Chunk 0 seeds at 16; its sync (after chunk 1's dispatch) decides; chunk
    # 2 re-seeds at 32; chunk 2's sync gives the verdict; chunk 4 re-seeds at
    # 16 only on a rollback.
    want_last = 32 if verdict == "held" else 16
    assert seeded == [(0, 16), (2, 32)] + ([] if verdict == "held" else [(4, 16)])
    assert len(errors) == 5
    assert study._scan_gp_control["n_inducing"] == want_last
    assert record["evidence"]["heldout_err"] == pytest.approx(errors[0])

    # The reference's loop on the same history and errors: decide at the
    # first sparse sync, judge rollback_after tells later.
    ref_study = optuna_tpu.create_study(sampler=optuna_tpu.samplers.RandomSampler(seed=0))
    trials = study.get_trials(deepcopy=False)
    ref_telemetry.enable(ref_telemetry.MetricsRegistry())
    ref_policy = ref_autopilot.AutopilotPolicy(mode="act", interval_s=0.0,
                                               overrides={"sparse_heldout_err_warn": 0.0},
                                               rollback_after=16, cooldown_s=3600.0,
                                               clock=lambda: 0.0, now=lambda: 0.0)
    ref_study._scan_gp_control = {"n_exact_max": 12, "n_inducing": 16}
    pilot = ref_autopilot.Autopilot(ref_study, ref_policy)
    dist = optuna_tpu.distributions.FloatDistribution(0.0, 1.0)

    def feed(upto: int, err: float):
        for t in trials[len(ref_study.trials):upto]:
            ref_study.add_trial(optuna_tpu.create_trial(
                params=t.params, distributions={k: dist for k in t.params}, value=t.value))
        ref_telemetry.set_gauge("device.gp.sparse_heldout_err.last", err)
        pilot.step()

    feed(8 + 8, errors[0])  # the sync of chunk 0
    assert ref_study._scan_gp_control["n_inducing"] == 32
    feed(8 + 16, errors[1])
    feed(8 + 24, errors[2])  # 16 finished trials after the decision: the verdict
    (ref_record,) = [r for r in pilot.report()["actions"] if r["action"] == "gp.densify"]
    assert ref_record["state"] == verdict
    assert ref_study._scan_gp_control["n_inducing"] == want_last


def test_the_executors_actuators_and_their_undos():
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.parallel.executor import ResilientBatchExecutor

    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    space = {"x": optuna_tpu_torch.distributions.FloatDistribution(0.0, 1.0)}
    executor = ResilientBatchExecutor(study, VectorizedObjective(lambda p: p["x"], space), batch_size=16,
                                      device="cpu")
    executor._batch_size = 4  # as after two OOM halvings
    undo_pin = executor.autopilot_pin_batch_width()
    assert executor._requested_batch_size == 4 and executor._grow_streak == 0
    for _ in range(4):
        executor._maybe_grow(4, 4)
    assert executor._batch_size == 4  # pinned: no regrowth probe
    undo_pin()
    assert executor._requested_batch_size == 16
    undo_tight = executor.autopilot_tighten_regrowth(3)
    assert executor._grow_streak_required == 3
    executor._maybe_grow(4, 4)
    executor._maybe_grow(4, 4)
    assert executor._batch_size == 4
    executor._maybe_grow(4, 4)
    assert executor._batch_size == 8
    undo_tight()
    assert executor._grow_streak_required == 2
    with pytest.raises(ValueError):
        executor.autopilot_tighten_regrowth(0)
    pilot = autopilot.Autopilot(study, autopilot.AutopilotPolicy(mode="act"))
    pilot._executor_ref = __import__("weakref").ref(executor)
    assert pilot._resolve_target("executor.pin_shapes") is executor
    assert pilot._resolve_target("service.shed_earlier") is None  # no hub until the serving tier


def test_the_cli_and_endpoint_surfaces_of_a_live_loop():
    study = optuna_tpu_torch.create_study(study_name="live")
    pilot = autopilot.attach(study, config="observe")
    assert pilot is autopilot.attach(study, config="observe")
    report = autopilot.export_report()
    assert any(p["study"] == "live" for p in report["autopilots"])
    assert "study 'live': mode=observe" in autopilot.render_text(report)
    assert autopilot.render_text({"enabled": False, "autopilots": []}).startswith("autopilot: not armed")
    assert torch.cuda.is_available() or study.__dict__["_autopilot"] is pilot
