"""The serve tier's chaos plans on the port, under the armed lock sanitizer.

The vocabularies are the reference's and each has its chaos matrix:
``SHED_POLICIES`` / ``SHED_CHAOS_POLICIES``, ``FLEET_EVENTS`` /
``HUB_CHAOS_MATRIX``, ``LEASE_EVENTS`` / ``LEASE_CHAOS_MATRIX``, and
``CHECKPOINT_EVENTS`` / ``CHECKPOINT_CHAOS_MATRIX`` (now with
``warm_load``); the plans' fields equal the reference's. Then the three
acceptances, each on an injected clock (a fleet's ``clock`` and ``now``
are frozen, so no lease or liveness window turns on the wall clock, and
the coalesce window is 0):

* ``ServiceChaosPlan``: slow-tell clients, a poison hub sampler (raise and
  NaN) whose degrades show on the served trials, a forced overload walked
  rung by rung with every shed counted exactly, the doctor's
  ``service.backpressure`` with the plan's evidence, nothing RUNNING after
  the drain;
* ``HubChaosPlan``: four hubs, the owner killed mid-burst after two
  committed-but-unacked asks replayed on the successor, every trial
  complete, the doctor naming the dead hub;
* ``LeaseChaosPlan``: the owner partitioned, the successor's takeover,
  zombie tells whose checkpoint writes the fence rejects (counted
  exactly), the heal's failback (epochs 1, 2, 3), the fault-free twin's
  best value.

The width-1 twin of config #2's GP runs here on the CPU at a small
history past ``n_exact_max`` (the sparse engine, K1's plain version). The
network chaos engine (``testing.netchaos``) takes the reference's
decisions on the same plans and script, and on the fleet a dropped ask is
redialed and a duplicated one deduped by its op token.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch import checkpoint, health, locksan, telemetry
from optuna_tpu_torch.distributions import FloatDistribution, distribution_to_json
from optuna_tpu_torch.samplers import BaseSampler, GPSampler, RandomSampler, TPESampler
from optuna_tpu_torch.storages import InMemoryStorage
from optuna_tpu_torch.storages._grpc.fleet import FLEET_EVENTS, LEASE_EVENTS, read_lease
from optuna_tpu_torch.storages._grpc.suggest_service import (
    SHED_POLICIES,
    ShedPolicy,
    SuggestService,
    ThinClientSampler,
    _ReadyEntry,
)
from optuna_tpu_torch.testing import fault_injection as fi
from optuna_tpu_torch.testing.netchaos import NetChaos, NetChaosPlan
from optuna_tpu_torch.trial import TrialState
from tests._torch_port import mount, one_torch_thread, thin_ask  # noqa: F401


@pytest.fixture(autouse=True)
def _lock_sanitizer():
    """Every scenario runs with the lock sanitizer armed: zero verdicts is
    part of each acceptance."""
    locksan.enable()
    yield
    verdicts = locksan.report()["verdicts"]
    locksan.disable()
    locksan.reset()
    assert verdicts == [], verdicts


@pytest.fixture(autouse=True)
def _observability(_lock_sanitizer, one_torch_thread):  # noqa: F811
    telemetry.enable(telemetry.MetricsRegistry())
    health.enable(interval_s=0.0)
    yield
    health.disable()
    telemetry.disable()
    optuna_tpu_torch.logging.reset_warn_once()


class Frozen:
    """An injected clock that stands still unless a test moves it."""

    def __init__(self, t: float) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _objective(trial) -> float:
    x = trial.suggest_float("x", -5.0, 5.0)
    y = trial.suggest_float("y", -5.0, 5.0)
    return (x - 1.0) ** 2 + (y + 2.0) ** 2


def _thin(rpc, **kwargs):
    return ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), **kwargs)


# ------------------------------------------------------------- vocabularies


@pytest.mark.parametrize(
    "port_vocab, port_matrix, ref_names",
    [
        (SHED_POLICIES, fi.SHED_CHAOS_POLICIES, ("storages._grpc.suggest_service.SHED_POLICIES",
                                                 "testing.fault_injection.SHED_CHAOS_POLICIES")),
        (FLEET_EVENTS, fi.HUB_CHAOS_MATRIX, ("storages._grpc.fleet.FLEET_EVENTS",
                                             "testing.fault_injection.HUB_CHAOS_MATRIX")),
        (LEASE_EVENTS, fi.LEASE_CHAOS_MATRIX, ("storages._grpc.fleet.LEASE_EVENTS",
                                               "testing.fault_injection.LEASE_CHAOS_MATRIX")),
        (checkpoint.CHECKPOINT_EVENTS, fi.CHECKPOINT_CHAOS_MATRIX, ("checkpoint.CHECKPOINT_EVENTS",
                                                                    "testing.fault_injection.CHECKPOINT_CHAOS_MATRIX")),
    ],
    ids=["shed", "fleet", "lease", "checkpoint"],
)
def test_each_vocabulary_has_its_chaos_matrix_and_is_the_references(port_vocab, port_matrix, ref_names):
    from importlib import import_module

    refs = []
    for dotted in ref_names:
        module, _, name = dotted.rpartition(".")
        refs.append(getattr(import_module("optuna_tpu." + module), name))
    assert set(port_vocab) == set(port_matrix) == set(refs[0]) == set(refs[1])
    assert port_vocab == refs[0]  # the vocabulary's texts too
    assert "warm_load" in checkpoint.CHECKPOINT_EVENTS


@pytest.mark.parametrize("plan", ["service_chaos_plan", "hub_chaos_plan", "lease_chaos_plan"])
def test_plans_equal_the_references(plan):
    from optuna_tpu.testing import fault_injection as ref_fi

    assert dataclasses.asdict(getattr(fi, plan)()) == dataclasses.asdict(getattr(ref_fi, plan)())


# ------------------------------------------------------------ service chaos


def test_service_chaos_acceptance():
    plan = fi.service_chaos_plan()
    storage = InMemoryStorage()
    faulty = fi.FaultySampler(
        TPESampler(multivariate=True, n_startup_trials=plan.n_startup_trials, seed=plan.seed, device="cpu"),
        raise_at=plan.sampler_raise_at,
        nan_at=plan.sampler_nan_at,
        force_relative=True,
    )
    service = SuggestService(storage, lambda: faulty, ready_ahead=0, coalesce_window_s=0.0, max_stale_epochs=0)
    mounted, rpc = mount(optuna_tpu_torch, storage, service)
    try:
        optuna_tpu_torch.create_study(storage=mounted, study_name="chaos", sampler=RandomSampler())
        sid = storage.get_study_id_from_name("chaos")
        per_client = plan.n_trials // plan.n_clients
        errors: list = []

        def client(seed):
            try:
                study = optuna_tpu_torch.load_study(study_name="chaos", storage=mounted, sampler=_thin(rpc, seed=seed))
                for _ in range(per_client):
                    trial = study.ask()
                    value = _objective(trial)
                    time.sleep(plan.slow_tell_s)  # the plan's slow tell, not a decision
                    study.tell(trial, value)
            except BaseException as err:  # noqa: BLE001 -- surfaced below
                errors.append(err)

        threads = [threading.Thread(target=client, args=(200 + i,)) for i in range(plan.n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not errors and not any(t.is_alive() for t in threads), errors
        study = optuna_tpu_torch.load_study(study_name="chaos", storage=mounted, sampler=RandomSampler())
        trials = study.trials
        assert len(trials) == plan.n_trials and all(t.state == TrialState.COMPLETE for t in trials)
        flagged = [t for t in trials if any(k.startswith("sampler_fallback:") for k in t.system_attrs)]
        assert len(flagged) == plan.expected_fallbacks
        counters = telemetry.snapshot()["counters"]
        assert sum(v for k, v in counters.items() if k.startswith("sampler.fallback")) == plan.expected_fallbacks

        before = dict(telemetry.snapshot()["counters"])
        service.shed_policy = ShedPolicy(degrade_depth=0, independent_depth=0, reject_depth=1, retry_after_s=0.001,
                                         slo_source=lambda: ())
        sleeps: list[float] = []
        burst = _thin(rpc, seed=999, max_shed_retries=0, sleep=sleeps.append)
        burst_study = optuna_tpu_torch.load_study(study_name="chaos", storage=mounted, sampler=burst)
        for _ in range(plan.burst_asks):
            trial = burst_study.ask()
            burst_study.tell(trial, _objective(trial))
        assert burst.sheds_seen == plan.burst_asks and sleeps == []  # zero retries: no sleep

        dists = {name: distribution_to_json(FloatDistribution(-5.0, 5.0)) for name in ("x", "y")}
        handle = service._handle(sid)
        handle.queue.refill([_ReadyEntry({"x": 0.25 * i, "y": -0.5 * i}, dists, handle.queue.epoch)
                             for i in range(1, plan.stale_burst_asks + 1)])
        handle.queue.invalidate()
        service.shed_policy = ShedPolicy(degrade_depth=0, independent_depth=64, reject_depth=128, slo_source=lambda: ())
        stale = _thin(rpc, seed=998)
        stale_study = optuna_tpu_torch.load_study(study_name="chaos", storage=mounted, sampler=stale)
        for _ in range(plan.stale_burst_asks):
            trial = stale_study.ask()
            stale_study.tell(trial, _objective(trial))
        assert list(stale.served_sources) == ["stale_queue"] * plan.stale_burst_asks

        handle.queue.refill([])
        service.shed_policy = ShedPolicy(degrade_depth=0, independent_depth=1, reject_depth=128, slo_source=lambda: ())
        indep_study = optuna_tpu_torch.load_study(study_name="chaos", storage=mounted, sampler=_thin(rpc, seed=997))
        for _ in range(plan.independent_burst_asks):
            trial = indep_study.ask()
            indep_study.tell(trial, _objective(trial))
        counters = telemetry.snapshot()["counters"]
        sheds = {k[len("serve.shed."):]: v - before.get(k, 0) for k, v in counters.items() if k.startswith("serve.shed.")}
        assert sheds == plan.expected_sheds

        findings = {f["check"]: f for f in study.health_report()["findings"]}
        assert findings["service.backpressure"]["evidence"]["sheds"] == plan.expected_sheds
        service.drain()
        final = optuna_tpu_torch.load_study(study_name="chaos", storage=mounted, sampler=RandomSampler()).trials
        assert all(t.state == TrialState.COMPLETE for t in final)
    finally:
        service.close()


def test_width1_twin_of_a_sparse_gp_equals_the_local_study():
    """Config #2's twin at a CPU size: a GP past ``n_exact_max`` (SGPR)
    served to a sequential thin client proposes the local study's params,
    with nothing contained on the way."""
    import numpy as np

    from optuna_tpu_torch.models.benchmarks import hartmann6

    rng = np.random.default_rng(0)
    dists = {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(6)}
    history = []
    for row in rng.uniform(size=(40, 6)):
        params = {f"x{i}": float(v) for i, v in enumerate(row)}
        history.append(optuna_tpu_torch.create_trial(
            params=params, distributions=dists, value=hartmann6(optuna_tpu_torch.trial.FixedTrial(params))))
    factory = lambda: GPSampler(seed=0, device="cpu", n_exact_max=32, n_inducing=16,  # noqa: E731
                                n_preliminary_samples=128)
    local = optuna_tpu_torch.create_study(sampler=factory())
    local.add_trials(history)
    local.optimize(hartmann6, n_trials=3)
    storage = InMemoryStorage()
    service = SuggestService(storage, factory, ready_ahead=0, coalesce_window_s=0.0, health_reporting=False)
    mounted, rpc = mount(optuna_tpu_torch, storage, service)
    optuna_tpu_torch.create_study(storage=mounted, study_name="twin", sampler=RandomSampler()).add_trials(history)
    client = _thin(rpc, seed=0)
    served = optuna_tpu_torch.load_study(study_name="twin", storage=mounted, sampler=client)
    served.optimize(hartmann6, n_trials=3)
    service.close()
    assert [t.params for t in served.trials[40:]] == [t.params for t in local.trials[40:]]
    assert list(client.served_sources) == ["coalesced"] * 3
    assert not any(k.startswith("sampler.fallback") for k in telemetry.snapshot()["counters"])


# ---------------------------------------------------------------- hub chaos


def _fleet(storage, names, factory, **kwargs):
    now = Frozen(time.time())  # one real stamp, then frozen: health snapshots stay comparable
    return fi.FakeHubFleet(storage, names, factory, clock=Frozen(0.0), now=now, **kwargs)


def test_hub_kill_chaos_acceptance():
    plan = fi.hub_chaos_plan()
    storage = InMemoryStorage()
    names = [f"hub-{i}" for i in range(plan.n_hubs)]
    fleet = _fleet(storage, names, lambda name: SuggestService(
        storage, lambda: TPESampler(multivariate=True, n_startup_trials=plan.n_startup_trials, seed=plan.seed,
                                    device="cpu"),
        ready_ahead=0, coalesce_window_s=0.0))
    mounted = fleet.mounted[names[0]]
    try:
        optuna_tpu_torch.create_study(storage=mounted, study_name="kill", sampler=RandomSampler())
        sid = storage.get_study_id_from_name("kill")
        victim = fleet.router.hub_for(sid)

        def run_trials(count, seed):
            study = optuna_tpu_torch.load_study(study_name="kill", storage=mounted, sampler=fleet.thin_client(seed=seed))
            for _ in range(count):
                trial = study.ask()
                study.tell(trial, _objective(trial))

        run_trials(plan.kill_after_trials, seed=100)
        fleet.drop_response(victim, "service_ask", count=plan.drop_responses)
        run_trials(plan.drop_responses, seed=101)
        assert telemetry.snapshot()["counters"]["serve.fleet.ask_replayed"] == plan.drop_responses
        fleet.kill(victim)
        remaining = plan.n_trials - plan.kill_after_trials - plan.drop_responses
        per_client = remaining // plan.n_clients
        errors: list = []

        def client(seed):
            try:
                run_trials(per_client, seed)
            except BaseException as err:  # noqa: BLE001 -- surfaced below
                errors.append(err)

        threads = [threading.Thread(target=client, args=(200 + i,)) for i in range(plan.n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not errors and not any(t.is_alive() for t in threads), errors
        study = optuna_tpu_torch.load_study(study_name="kill", storage=mounted, sampler=RandomSampler())
        trials = study.trials
        assert len(trials) == plan.kill_after_trials + plan.drop_responses + per_client * plan.n_clients
        assert all(t.state == TrialState.COMPLETE and set(t.params) == {"x", "y"} for t in trials)
        counters = telemetry.snapshot()["counters"]
        assert counters["serve.fleet.hub_dead"] >= 1 and counters["serve.fleet.hub_rehome"] >= 1
        findings = {f["check"]: f for f in study.health_report()["findings"]}
        assert findings["service.hub_dead"]["evidence"]["dead_hubs"] == [victim]
    finally:
        fleet.close()


# -------------------------------------------------------------- lease chaos


def _pure(name: str, number: int) -> float:
    salt = sum(ord(c) for c in name)
    return -5.0 + 10.0 * (((number * 37 + salt * 11) % 101) / 100.0)


class PureSampler(BaseSampler):
    """Params a pure function of the trial number: any hub proposes trial
    N's point, so the fence is what is under test. Exports a fitted state
    so the checkpoint cadence writes ``ckpt:hub`` frames to fence."""

    space = {"x": FloatDistribution(-5.0, 5.0), "y": FloatDistribution(-5.0, 5.0)}

    def infer_relative_search_space(self, study, trial):
        return dict(self.space)

    def sample_relative(self, study, trial, search_space):
        return {name: _pure(name, trial.number) for name in search_space}

    def sample_independent(self, study, trial, param_name, param_distribution):
        return _pure(param_name, trial.number)

    def export_fitted_state(self):
        return {"pure": True}

    def restore_fitted_state(self, state) -> bool:
        return True


def _ckpt_attrs(storage, sid):
    return {k: v for k, v in storage.get_study_system_attrs(sid).items() if k.startswith(checkpoint.CKPT_ATTR_PREFIX)}


def test_lease_partition_chaos_acceptance():
    plan = fi.lease_chaos_plan()
    storage = InMemoryStorage()
    names = [f"hub-{i}" for i in range(plan.n_hubs)]
    fleet = _fleet(storage, names, lambda name: SuggestService(
        storage, PureSampler, ready_ahead=0, coalesce_window_s=0.0, checkpoint_every=1),
        lease_check_ttl_s=plan.lease_check_ttl_s)
    chaos = NetChaos()
    chaos.attach_fleet(fleet)
    try:
        optuna_tpu_torch.create_study(storage=storage, study_name="lease", sampler=RandomSampler())
        sid = storage.get_study_id_from_name("lease")
        victim = fleet.router.hub_for(sid)
        successor = next(n for n in names if n != victim)
        study = optuna_tpu_torch.load_study(study_name="lease", storage=storage, sampler=fleet.thin_client())

        def run_trials(count):
            for _ in range(count):
                trial = study.ask()
                study.tell(trial, _objective(trial))

        run_trials(plan.partition_after_trials)
        assert (read_lease(storage, sid)["owner"], read_lease(storage, sid)["epoch"]) == (victim, 1)
        fleet.kill(victim)
        chaos.partition(victim, "symmetric")
        run_trials(plan.n_trials - plan.partition_after_trials - plan.zombie_tells - 3)
        assert (read_lease(storage, sid)["owner"], read_lease(storage, sid)["epoch"]) == (successor, 2)

        before = _ckpt_attrs(storage, sid)
        zombie = optuna_tpu_torch.load_study(
            study_name="lease", storage=fleet.mounted[victim],
            sampler=ThinClientSampler(
                lambda s, t, n, token: fleet.hubs[victim].service_ask(s, t, n, op_token=token)),
        )
        for _ in range(plan.zombie_tells):
            trial = zombie.ask()
            zombie.tell(trial, _objective(trial))
            fleet.kill(victim)  # its heartbeat does not cross the partition either
        assert _ckpt_attrs(storage, sid) == before
        chaos.heal(victim)
        fleet.heal(victim)
        run_trials(3)

        trials = study.trials
        assert len(trials) == plan.n_trials and all(t.state == TrialState.COMPLETE for t in trials)
        assert sorted(t.number for t in trials) == list(range(plan.n_trials))
        assert all(t.params == {"x": _pure("x", t.number), "y": _pure("y", t.number)} for t in trials)
        counters = telemetry.snapshot()["counters"]
        assert counters["fleet.fenced_write"] == plan.zombie_tells
        assert counters["fleet.lease.demote"] == 1
        assert counters["fleet.lease.takeover"] == 2 and counters["fleet.lease.acquire"] == 1
        assert counters.get("serve.fleet.ask_replayed", 0) == 0
        lease = read_lease(storage, sid)
        assert [(h["owner"], h["epoch"]) for h in lease["history"]] == [(victim, 1), (successor, 2), (victim, 3)]
        twin = optuna_tpu_torch.create_study(sampler=PureSampler())
        for _ in range(plan.n_trials):
            trial = twin.ask()
            twin.tell(trial, _objective(trial))
        assert (study.best_value, study.best_params) == (twin.best_value, twin.best_params)
        findings = {f["check"]: f for f in study.health_report()["findings"]}
        assert findings["service.hub_zombie_fenced"]["evidence"]["fenced_writes"] > 0
        assert "service.hub_flapping" not in findings
    finally:
        fleet.close()


# ----------------------------------------------------------------- netchaos


class _Unavailable(Exception):
    pass


def _engine_run(pkg, plan_kwargs, script):
    """Drive ``pkg``'s netchaos engine through ``script`` ((link, method)
    calls, or ("partition"/"heal", link, mode) taps); returns each call's
    outcome and the injected counts."""
    from importlib import import_module

    net = import_module(pkg.__name__ + ".testing.netchaos")
    chaos = net.NetChaos(net.NetChaosPlan(**plan_kwargs))
    out, executed = [], []
    for step in script:
        if step[0] == "partition":
            chaos.partition(step[1], step[2])
            continue
        if step[0] == "heal":
            chaos.heal(step[1])
            continue
        link, method = step
        try:
            out.append(chaos.apply(link, method, lambda: executed.append(len(executed)) or len(executed),
                                   _Unavailable))
        except _Unavailable:
            out.append("unavailable")
    return out, list(executed), dict(chaos.injected)


@pytest.mark.parametrize(
    "plan_kwargs",
    [
        {"drop": {"m": [1, 3]}, "duplicate": {"n": [0, 2]}},
        {"drop": {"*": [0]}, "max_faults": 0},
        {"seed": 7, "drop_rate": 0.5, "max_faults": 3},
        {"seed": 11, "drop_rate": 0.2, "duplicate_rate": 0.3, "methods": ("m",)},
    ],
    ids=["scheduled", "any-method", "seeded-budget", "seeded-mixed"],
)
def test_netchaos_engine_equals_the_references(plan_kwargs):
    script = [("a", "m"), ("a", "n"), ("b", "m")] * 6
    script[7:7] = [("partition", "b", "symmetric")]
    script[10:10] = [("heal", "b"), ("partition", "a", "oneway")]
    script[13:13] = [("heal", "a")]
    port = _engine_run(optuna_tpu_torch, plan_kwargs, script)
    ref = _engine_run(optuna_tpu, plan_kwargs, script)
    assert port == ref
    assert port[2]  # every plan injected something


def test_netchaos_on_the_fleet_drop_redials_and_duplicate_dedupes():
    storage = InMemoryStorage()
    fleet = _fleet(storage, ["hub-0", "hub-1"], lambda name: SuggestService(
        storage, lambda: RandomSampler(seed=5), ready_ahead=0, coalesce_window_s=0.0))
    chaos = NetChaos(NetChaosPlan(drop={"service_ask": [0]}, duplicate={"service_ask": [1]}))
    chaos.attach_fleet(fleet)
    try:
        optuna_tpu_torch.create_study(storage=storage, study_name="net", sampler=RandomSampler())
        study = optuna_tpu_torch.load_study(study_name="net", storage=storage, sampler=fleet.thin_client(seed=1))
        for _ in range(4):
            trial = study.ask()
            study.tell(trial, trial.suggest_float("x", -5.0, 5.0) ** 2)
        assert [t.state for t in study.trials] == [TrialState.COMPLETE] * 4
        assert chaos.injected.get("drop", 0) >= 1 and chaos.injected.get("duplicate", 0) >= 1
        assert telemetry.snapshot()["counters"].get("grpc.op_token_dedup", 0) >= 1
    finally:
        fleet.close()
