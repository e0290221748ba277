"""The port's hub fleet against the reference's.

Routes, replay slots, lease records and ``ckpt:hub`` blobs are the
reference's bit for bit: ``FleetRouter`` sends study ids 0-999 to the same
hubs in the same ring order, a lease written by one package is read, taken
over and fenced by the other, and a hub checkpoint written by either
package warm-loads the other's ``GPSampler``. Every lease TTL and liveness
window here runs on an injected clock. The port's ``FakeHubFleet`` mounts
its hubs behind the grpc-free dispatcher: a subprocess with ``grpc``
blocked imports the serve tier and serves an ask through it. Then the
fleet's failover: a committed-but-unacked ask replays on the successor,
a killed owner's study re-homes with an epoch bump and a counted warm load,
a mis-routed ask is forwarded, an overloaded hub sheds forward, and the
fleet of one writes what a single hub writes.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from importlib import import_module

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch import checkpoint, health, telemetry
from optuna_tpu_torch.exceptions import StaleLeaseError
from optuna_tpu_torch.samplers import RandomSampler
from optuna_tpu_torch.storages import InMemoryStorage, RetryPolicy
from optuna_tpu_torch.storages._grpc.fleet import (
    REPLAY_SLOTS,
    FleetClient,
    FleetHub,
    FleetReplicator,
    FleetRouter,
    HubUnavailableError,
    StudyLeases,
    dead_hubs,
    read_lease,
)
from optuna_tpu_torch.storages._grpc.suggest_service import ShedPolicy, SuggestService
from optuna_tpu_torch.testing.fault_injection import FakeHubFleet, plant_dead_worker
from tests._torch_port import serve_objective, stub_sampler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _registry():
    telemetry.enable(telemetry.MetricsRegistry())
    yield
    telemetry.disable()
    optuna_tpu_torch.logging.reset_warn_once()


class Clock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _fleet_mod(pkg):
    return import_module(pkg.__name__ + ".storages._grpc.fleet")


def _study(storage, name="s") -> int:
    optuna_tpu_torch.create_study(storage=storage, study_name=name, sampler=RandomSampler(seed=0))
    return storage.get_study_id_from_name(name)


# ------------------------------------------------------------------ router


@pytest.mark.parametrize(
    "hubs", [["hub-0", "hub-1", "hub-2"], ["localhost:50051", "localhost:50052", "10.0.0.7:50051"]]
)
def test_router_routes_equal_the_references(hubs):
    ref, port = _fleet_mod(optuna_tpu).FleetRouter(hubs), FleetRouter(hubs)
    assert [port.hub_for(sid) for sid in range(1000)] == [ref.hub_for(sid) for sid in range(1000)]
    assert [port.successors(sid) for sid in range(1000)] == [ref.successors(sid) for sid in range(1000)]
    alive = frozenset(hubs[1:])
    assert [port.route(sid, alive) for sid in range(200)] == [ref.route(sid, alive) for sid in range(200)]
    counts = {h: sum(port.hub_for(s) == h for s in range(1000)) for h in hubs}
    assert min(counts.values()) > 200  # balanced enough that no hub idles


def test_router_rejects_empty_and_duplicate_hub_lists():
    with pytest.raises(ValueError):
        FleetRouter([])
    with pytest.raises(ValueError):
        FleetRouter(["a", "a"])


# -------------------------------------------------------------- replicator


def test_replay_slots_equal_the_references():
    ref = _fleet_mod(optuna_tpu).FleetReplicator
    tokens = [f"{i:032x}" for i in range(0, 10**6, 997)]
    assert [FleetReplicator._slot(t) for t in tokens] == [ref._slot(t) for t in tokens]


def test_replicator_replays_by_token_in_a_bounded_ring():
    storage = InMemoryStorage()
    sid = _study(storage)
    rep = FleetReplicator(storage, now=Clock(1000.0))
    rep.record_ask(sid, "tok-1", {"params": {"x": 1.5}})
    assert rep.lookup_ask(sid, "tok-1") == {"params": {"x": 1.5}}
    assert rep.lookup_ask(sid, "never") is None
    for i in range(3 * REPLAY_SLOTS):
        rep.record_ask(sid, f"tok-{i}", {"params": {"x": float(i)}})
    slots = [k for k in storage.get_study_system_attrs(sid) if k.startswith("serve:fleet:tok:")]
    assert len(slots) <= REPLAY_SLOTS
    rep.record_watermark(sid, "hub-a", epoch=3)
    rep.record_watermark(sid, "hub-b", epoch=7, asks=12)
    assert rep.watermark_epoch(sid) == 7
    # A replay slot overwritten inside the retry window is counted loud.
    assert rep.lookup_ask(sid, "tok-1") is None
    assert telemetry.snapshot()["counters"].get("grpc.op_token_evicted_live", 0) >= 1


# --------------------------------------------------------------- liveness


def test_dead_hubs_derive_from_stale_serve_snapshots():
    storage = InMemoryStorage()
    sid = _study(storage)
    study = optuna_tpu_torch.load_study(study_name="s", storage=storage, sampler=RandomSampler())
    suffix = health.HUB_WORKER_ID_SUFFIX
    plant_dead_worker(study, worker_id="hub-a" + suffix, age_s=3600.0)
    plant_dead_worker(study, worker_id="hub-b" + suffix, age_s=0.0)
    plant_dead_worker(study, worker_id="plain-worker", age_s=3600.0)
    assert dead_hubs(storage, sid, ["hub-a", "hub-b", "hub-c"]) == frozenset({"hub-a"})
    snap = plant_dead_worker(study, worker_id="hub-a" + suffix, age_s=3600.0)
    snap["final"] = True
    storage.set_study_system_attr(sid, health.WORKER_ATTR_PREFIX + "hub-a" + suffix, snap)
    assert dead_hubs(storage, sid, ["hub-a"]) == frozenset()


# ------------------------------------------------------------------ leases


def _journals(path):
    out = {}
    for name, pkg in (("ref", optuna_tpu), ("port", optuna_tpu_torch)):
        journal = import_module(pkg.__name__ + ".storages.journal")
        out[name] = journal.JournalStorage(journal.JournalFileBackend(str(path)))
    return out


def test_lease_records_cross_packages_on_an_injected_clock(tmp_path):
    """The reference's hub acquires; the port's cannot until the lease ages
    past grace on the injected unix clock, then takes over (epoch 2) and
    renews at ttl/2 on the injected monotonic clock; the reference's fence
    trips on the port's record, and a reference failback fences the port."""
    stores = _journals(tmp_path / "lease.journal")
    sid = stores["ref"].create_new_study([optuna_tpu.study.StudyDirection.MINIMIZE], "leased")
    clock, now = Clock(), Clock(1000.0)
    ref_fleet = _fleet_mod(optuna_tpu)
    ref_hub = ref_fleet.StudyLeases(stores["ref"], "hub-a", ttl_s=10.0, check_ttl_s=0.0, clock=clock, now=now)
    port_hub = StudyLeases(stores["port"], "hub-b", ttl_s=10.0, check_ttl_s=0.0, clock=clock, now=now)
    assert ref_hub.acquire(sid) == 1
    assert port_hub.acquire(sid) == 0  # a valid lease stands
    now.t += port_hub.grace_factor * 10.0 + 1.0
    assert port_hub.acquire(sid) == 2
    record = ref_fleet.read_lease(stores["ref"], sid)
    assert (record["owner"], record["epoch"]) == ("hub-b", 2)
    assert [h["epoch"] for h in record["history"]] == [1, 2]
    with pytest.raises(optuna_tpu.exceptions.StaleLeaseError):
        ref_hub.check_fence(sid)
    renewed = read_lease(stores["port"], sid)["renewed_unix"]
    now.t += 1.0
    clock.t += 4.0
    assert port_hub.tick(sid) == 2 and read_lease(stores["port"], sid)["renewed_unix"] == renewed  # not due
    clock.t += 1.0
    port_hub.tick(sid)  # due at ttl/2
    assert read_lease(stores["port"], sid)["renewed_unix"] == now.t
    assert telemetry.snapshot()["counters"]["fleet.lease.renew"] == 1
    assert ref_hub.acquire(sid, takeover=True) == 3  # failback
    clock.t += 5.0
    with pytest.raises(StaleLeaseError) as info:
        port_hub.tick(sid)
    assert (info.value.held_epoch, info.value.fence_epoch, info.value.owner) == (2, 3, "hub-a")
    port_hub.release(sid)  # not the owner: a no-op
    assert read_lease(stores["port"], sid)["owner"] == "hub-a"


# ------------------------------------------------------------ fleet client


def _no_sleep(attempts=7):
    return RetryPolicy(max_attempts=attempts, sleep=lambda _s: None)


def test_fleet_client_redials_the_next_replica_with_the_same_token():
    router = FleetRouter(["a", "b", "c"])
    order = router.successors(3)
    calls = []

    def make(hub):
        def ask(study_id, trial_id, number, token, redial):
            calls.append((hub, token, redial))
            if hub == order[0]:
                raise HubUnavailableError("injected")
            return {"params": {}, "hub": hub}

        return ask

    client = FleetClient(router, {h: make(h) for h in router.hubs}, retry_policy=_no_sleep())
    assert client.ask(3, 0, 0, "tok-x")["hub"] == order[1]
    assert calls == [(order[0], "tok-x", False), (order[1], "tok-x", True)]
    dead = FleetClient(router, {h: make(order[0]) for h in router.hubs}, retry_policy=_no_sleep(4))
    with pytest.raises(HubUnavailableError):
        dead.ask(3, 0, 0, "tok-y")
    with pytest.raises(ValueError, match="b"):
        FleetClient(router, {"a": lambda *a: {}, "c": lambda *a: {}})


def test_least_burning_peer_matches_the_references_ranking():
    verdicts = {
        "idle": {"score": 0.0, "depth": 1},
        "busy": {"score": 1.0, "depth": 5, "burning": True},
        "onfire": {"score": 0.0, "critical": True},
        "leaving": {"draining": True},
    }
    picks = {}
    for name, pkg in (("ref", optuna_tpu), ("port", optuna_tpu_torch)):
        fm = _fleet_mod(pkg)

        class Peer:
            def __init__(self, verdict):
                self.verdict = verdict

            def service_burn_verdict(self):
                return dict(self.verdict)

        class Svc:
            _health_worker_id = "me-serve"

        router = fm.FleetRouter(["me", *verdicts])
        hub = fm.FleetHub("me", Svc(), router, pkg.storages.InMemoryStorage(),
                          peers={k: Peer(v) for k, v in verdicts.items()})
        alive = frozenset(router.hubs)
        picks[name] = [hub._least_burning_peer(alive), hub._least_burning_peer(alive - {"idle"}),
                       hub._least_burning_peer(frozenset({"onfire", "leaving"}))]
    assert picks["port"] == picks["ref"] == ["idle", "busy", None]


# ------------------------------------------------------- the in-process fleet


class _FittedStub:
    """The stub sampler with a fitted state to export and warm-load."""

    def __init__(self) -> None:
        self.inner = stub_sampler(optuna_tpu_torch, seed=0, startup=0)
        self.restored = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def export_fitted_state(self):
        return {"kernel_params_cache": {("x", "y"): [np.arange(3.0)]}}

    def restore_fitted_state(self, state):
        self.restored = state
        return True


def _fleet(storage, names, clock, now, **service_kwargs):
    service_kwargs.setdefault("ready_ahead", 0)
    service_kwargs.setdefault("coalesce_window_s", 0.0)
    service_kwargs.setdefault("health_reporting", False)
    return FakeHubFleet(
        storage, names, lambda name: SuggestService(storage, _FittedStub, clock=clock, **service_kwargs),
        lease_check_ttl_s=0.0, clock=clock, now=now,
    )


def _served(fleet, mount, name="s"):
    return optuna_tpu_torch.load_study(study_name=name, storage=fleet.mounted[mount], sampler=fleet.thin_client(seed=0))


def test_dropped_answer_replays_kill_rehomes_and_warm_loads():
    """Phase 35(c) on the CPU: a committed-but-unacked ask replays on the
    ring successor (one proposal, not two); a killed owner's study
    re-homes to the survivor with a bumped lease epoch and one counted warm
    load of its ``ckpt:hub`` blob; every trial completes."""
    clock, now = Clock(), Clock(10_000.0)
    storage = InMemoryStorage()
    names = ["hub-0", "hub-1"]
    fleet = _fleet(storage, names, clock, now, checkpoint_every=4)
    try:
        sid = _study(fleet.mounted[names[0]])
        owner = fleet.router.hub_for(sid)
        survivor = next(n for n in names if n != owner)
        study = _served(fleet, owner)
        study.optimize(serve_objective, n_trials=4)
        proposals = lambda hub: len(fleet.hubs[hub].service._handles[sid].guarded._sampler.inner.widths)  # noqa: E731
        assert proposals(owner) == 4 and read_lease(storage, sid)["epoch"] == 1
        fleet.drop_response(owner, "service_ask", 1)
        study.optimize(serve_objective, n_trials=4)
        counters = telemetry.snapshot()["counters"]
        assert counters["serve.fleet.ask_replayed"] == 1 and proposals(owner) == 8
        assert checkpoint.load_checkpoint(storage, sid, "hub").n_told == 8
        fleet.kill(owner)
        study.optimize(serve_objective, n_trials=4)
        counters = telemetry.snapshot()["counters"]
        assert counters["serve.fleet.hub_dead"] == 1 and counters["serve.fleet.hub_rehome"] == 1
        assert counters["checkpoint.warm_load"] == 1
        heir = fleet.hubs[survivor].service._handles[sid].guarded._sampler
        assert list(heir.restored["kernel_params_cache"]) == [("x", "y")]
        lease = read_lease(storage, sid)
        assert (lease["owner"], lease["epoch"]) == (survivor, 2)
        assert [t.state.name for t in study.trials] == ["COMPLETE"] * 12
    finally:
        fleet.close()


def test_misrouted_ask_is_forwarded_and_an_overloaded_hub_sheds_forward():
    clock, now = Clock(), Clock(10_000.0)
    storage = InMemoryStorage()
    names = ["hub-0", "hub-1"]
    fleet = _fleet(storage, names, clock, now)
    try:
        sid = _study(fleet.mounted[names[0]])
        owner = fleet.router.hub_for(sid)
        other = next(n for n in names if n != owner)
        study = optuna_tpu_torch.load_study(study_name="s", storage=fleet.mounted[other], sampler=RandomSampler())
        trial = study.ask()
        resp = fleet.rpc(other, "service_ask", sid, trial._trial_id, trial.number, __op_token="t1")
        assert resp["source"] == "coalesced" and resp["params"]
        assert telemetry.snapshot()["counters"]["serve.fleet.ask_forward"] == 1
        assert fleet.hubs[owner].service._handles[sid].guarded._sampler.inner.widths == [1]
        fleet.hubs[owner].service.shed_policy = ShedPolicy(
            degrade_depth=0, independent_depth=0, reject_depth=0, slo_source=lambda: (), clock=clock
        )
        trial = study.ask()
        resp = fleet.rpc(owner, "service_ask", sid, trial._trial_id, trial.number, __op_token="t2")
        assert resp["shed"] is None and resp["params"]
        assert telemetry.snapshot()["counters"]["serve.fleet.shed_forward"] == 1
    finally:
        fleet.close()


def test_an_owners_device_fault_on_a_forwarded_ask_is_raised_not_answered_locally():
    """The owner's sampler hits a device fault on a forwarded ask: the
    forwarding hub answers that error (never a proposal of its own), and a
    thin client walking the fleet raises it with no fallback attr."""
    clock, now = Clock(), Clock(10_000.0)
    storage = InMemoryStorage()
    names = ["hub-0", "hub-1"]
    faulty: set[str] = set()

    def service(name):
        def factory():
            fail = RuntimeError("CUDA error: an illegal memory access was encountered") if name in faulty else None
            return stub_sampler(optuna_tpu_torch, startup=0, fail_with=fail)

        return SuggestService(
            storage, factory, clock=clock, ready_ahead=0, coalesce_window_s=0.0, health_reporting=False
        )

    fleet = FakeHubFleet(storage, names, service, lease_check_ttl_s=0.0, clock=clock, now=now)
    try:
        sid = _study(fleet.mounted[names[0]])
        owner = fleet.router.hub_for(sid)
        other = next(n for n in names if n != owner)
        faulty.add(owner)
        study = optuna_tpu_torch.load_study(study_name="s", storage=fleet.mounted[other], sampler=RandomSampler())
        trial = study.ask()
        with pytest.raises(RuntimeError, match="CUDA error"):
            fleet.rpc(other, "service_ask", sid, trial._trial_id, trial.number, __op_token="t1")
        assert telemetry.snapshot()["counters"]["serve.fleet.ask_forward"] == 1
        assert sid not in fleet.hubs[other].service._handles  # nothing answered locally
        client = optuna_tpu_torch.load_study(study_name="s", storage=fleet.mounted[other], sampler=fleet.thin_client(seed=0))
        with pytest.raises(RuntimeError, match="CUDA error"):
            client.ask()
        assert not any(k.startswith("sampler_fallback:") for t in study.get_trials() for k in t.system_attrs)
    finally:
        fleet.close()


def test_a_fleet_of_one_writes_what_a_single_hub_writes():
    from tests._torch_port import mount, thin_ask
    from optuna_tpu_torch.storages._grpc.suggest_service import ThinClientSampler

    def run(solo: bool) -> dict:
        storage = InMemoryStorage()
        if solo:
            fleet = _fleet(storage, ["only"], Clock(), Clock(10_000.0))
            _study(fleet.mounted["only"])
            study = _served(fleet, "only")
        else:
            service = SuggestService(storage, _FittedStub, ready_ahead=0, coalesce_window_s=0.0, health_reporting=False)
            mounted, rpc = mount(optuna_tpu_torch, storage, service)
            _study(mounted)
            study = optuna_tpu_torch.load_study(
                study_name="s", storage=mounted, sampler=ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), seed=0)
            )
        study.optimize(serve_objective, n_trials=6)
        return {"params": [t.params for t in study.trials], "attrs": storage.get_study_system_attrs(0)}

    solo, single = run(True), run(False)
    assert solo == single
    assert not any(k.startswith(("lease:", "serve:fleet:")) for k in solo["attrs"])


# -------------------------------------------------- ckpt:hub across packages


def test_hub_checkpoints_warm_load_across_packages(tmp_path):
    """A port hub's ``ckpt:hub`` blob of a fitted port ``GPSampler`` restores
    into the reference's ``GPSampler``; the reference's blob of that state
    restores into a fresh port ``GPSampler``: the same cache both ways."""
    from optuna_tpu.checkpoint import load_checkpoint as ref_load
    from optuna_tpu.checkpoint import write_checkpoint as ref_write
    from optuna_tpu.samplers import GPSampler as RefGP
    from optuna_tpu_torch.samplers import GPSampler

    stores = _journals(tmp_path / "warm.journal")
    sid = stores["port"].create_new_study([optuna_tpu_torch.study.StudyDirection.MINIMIZE], "warm")
    service = SuggestService(
        stores["port"], lambda: GPSampler(seed=0, device="cpu", n_startup_trials=4, n_preliminary_samples=64),
        ready_ahead=0, coalesce_window_s=0.0, health_reporting=False, checkpoint_every=8,
    )
    from tests._torch_port import mount, thin_ask
    from optuna_tpu_torch.storages._grpc.suggest_service import ThinClientSampler

    mounted, rpc = mount(optuna_tpu_torch, stores["port"], service)
    study = optuna_tpu_torch.load_study(
        study_name="warm", storage=mounted, sampler=ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), seed=0)
    )
    study.optimize(serve_objective, n_trials=8)
    service.close()
    record = ref_load(stores["ref"], sid, "hub")
    assert record is not None and record.n_told == 8
    ref_gp = RefGP(seed=0)
    assert ref_gp.restore_fitted_state(record.state["sampler"])
    exported = ref_gp.export_fitted_state()
    ref_write(stores["ref"], sid, "hub", {"sampler": exported, "epoch": 5}, n_told=9, seq=record.seq + 1)
    back = checkpoint.load_checkpoint(stores["port"], sid, "hub")
    assert back.seq == record.seq + 1 and back.state["epoch"] == 5
    port_gp = GPSampler(seed=0, device="cpu")
    assert checkpoint.restore_sampler_state(port_gp, back.state["sampler"])
    want = record.state["sampler"]["kernel_params_cache"]
    got = port_gp.export_fitted_state()["kernel_params_cache"]
    assert list(got) == list(want)
    for sig in want:
        np.testing.assert_array_equal(np.asarray(got[sig][0]), np.asarray(want[sig][0]))


# ------------------------------------------------------------ without grpc


def test_the_serve_tier_imports_and_serves_without_grpc():
    """``grpc`` blocked in a fresh interpreter: the package, the wire, the
    dispatcher, the service, the fleet and the chaos kit import, and a
    two-hub ``FakeHubFleet`` serves a width-1 ask."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["grpc"] = None
        import optuna_tpu_torch
        from optuna_tpu_torch.storages._grpc import _service, fleet, server, suggest_service
        from optuna_tpu_torch.testing import fault_injection
        from optuna_tpu_torch.samplers import RandomSampler
        from optuna_tpu_torch.storages import InMemoryStorage

        storage = InMemoryStorage()
        hubs = fault_injection.FakeHubFleet(
            storage, ["a", "b"],
            lambda name: suggest_service.SuggestService(
                storage, lambda: RandomSampler(seed=0), ready_ahead=0, coalesce_window_s=0.0,
                health_reporting=False),
        )
        optuna_tpu_torch.create_study(storage=hubs.mounted["a"], study_name="s", sampler=RandomSampler())
        study = optuna_tpu_torch.load_study(study_name="s", storage=hubs.mounted["a"], sampler=hubs.thin_client(seed=0))
        trial = study.ask()
        study.tell(trial, trial.suggest_float("x", 0.0, 1.0))
        assert study.trials[0].state.name == "COMPLETE"
        assert sys.modules["grpc"] is None and not any(m.startswith("jax") for m in sys.modules)
        print("served", study.trials[0].params)
        """
    )
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served {'x':" in out.stdout
