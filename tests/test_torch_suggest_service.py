"""The port's suggestion service and thin client against the reference's.

The decisions are held step for step: one script of asks, tells, refills
and forced shed rungs drives both packages' ``SuggestService`` (a stub
server-resident sampler per package drawing from one ``RandomState``, a
scripted clock, the refill worker's requests recorded instead of run), and
every answer's source and params, every ``state()`` and every refill
request must be equal. The coalescer's window, the ready queue's epochs and
the shed ladder are compared alone too. Then the port's own contract: a
burst of concurrent asks is one dispatch of distinct proposals; a
sequential thin client equals the local study (TPE on the CPU, three
backing storages); op-token replay; the fallback attr's round trip; the
drain; and device faults, which are never contained: the dispatcher
answers one as an error, the refill worker re-raises it on the study's
next ask, and the thin client raises it. One ``cuda`` test serves config
#2's GP from the card (phase 35(a)'s twin at a smaller history).
"""

from __future__ import annotations

import threading
from importlib import import_module

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch import telemetry
from optuna_tpu_torch.samplers import RandomSampler, TPESampler
from optuna_tpu_torch.storages import InMemoryStorage
from optuna_tpu_torch.storages._grpc.suggest_service import (
    SHED_POLICIES,
    ShedPolicy,
    SuggestService,
    ThinClientSampler,
    _AskCoalescer,
    _PendingAsk,
    _ReadyEntry,
    _ReadyQueue,
)
from tests._torch_port import cuda_device  # noqa: F401  (fixture)
from tests._torch_port import mount, one_torch_thread, serve_objective, stub_sampler, thin_ask  # noqa: F401

PKGS = {"ref": optuna_tpu, "port": optuna_tpu_torch}


@pytest.fixture(autouse=True)
def _isolated_registry(one_torch_thread):  # noqa: F811
    saved = telemetry.get_registry(), telemetry.enabled()
    telemetry.enable(telemetry.MetricsRegistry())
    yield
    telemetry.enable(saved[0])
    if not saved[1]:
        telemetry.disable()
    optuna_tpu_torch.logging.reset_warn_once()


def _ss(pkg):
    return import_module(pkg.__name__ + ".storages._grpc.suggest_service")


class ScriptedClock:
    """A clock that moves only when the test says so."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------- step-for-step parity


def _scripted_run(pkg) -> list:
    """One script through ``pkg``'s service; returns what every step saw."""
    ss = _ss(pkg)
    clock = ScriptedClock()
    samplers = []

    def factory():
        samplers.append(stub_sampler(pkg, seed=3))
        return samplers[-1]

    storage = pkg.storages.InMemoryStorage()
    policy = ss.ShedPolicy(degrade_depth=64, independent_depth=96, reject_depth=128, clock=clock, slo_source=lambda: ())
    service = ss.SuggestService(
        storage, factory, coalesce_window_s=0.0, max_coalesce=4, ready_ahead=4, invalidate_after=2,
        max_stale_epochs=1, shed_policy=policy, clock=clock, health_reporting=False, checkpoint_every=0,
    )
    requests: list = []
    service._maybe_request_refill = lambda sid, handle, demand=False: requests.append((sid, demand))
    mounted, rpc = mount(pkg, storage, service)
    pkg.create_study(storage=mounted, study_name="served")
    answers: list = []
    ask = thin_ask(pkg, rpc)

    def recording_ask(*args):
        answers.append(ask(*args))
        return answers[-1]

    sampler = ss.ThinClientSampler(recording_ask, seed=5, max_shed_retries=0, sleep=lambda _s: None)
    study = pkg.load_study(study_name="served", storage=mounted, sampler=sampler)
    sid = study._study_id
    seen = []
    script = ["ask"] * 3 + ["reject", "ask", "independent", "ask", "refill", "ask", "ask", "invalidate",
                            "invalidate", "stale", "ask", "ask", "ask", "refill", "ask", "ask", "ask", "ask", "ask"]
    for step in script:
        if step == "refill":
            seen.append(("refill", service.refill_now(sid)))
        elif step == "invalidate":
            service._handles[sid].queue.invalidate()
        elif step in ("reject", "independent", "stale"):
            depth = {"reject": (0, 0, 1), "independent": (0, 1, 128), "stale": (1, 64, 128)}[step]
            policy.degrade_depth, policy.independent_depth, policy.reject_depth = depth
        else:
            trial = study.ask()
            value = serve_objective(trial)
            study.tell(trial, value)
            answer = answers[-1]
            seen.append(("ask", answer.get("shed") or answer.get("source"), answer, dict(trial.params), value))
            policy.degrade_depth, policy.independent_depth, policy.reject_depth = 64, 96, 128
            clock.t += 0.01
        seen.append(("state", service.state(), list(requests), list(samplers[0].widths) if samplers else []))
    service.close()
    return seen


def test_service_decisions_equal_the_references_step_for_step():
    ref, port = _scripted_run(optuna_tpu), _scripted_run(optuna_tpu_torch)
    assert len(port) == len(ref)
    for k, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (k, a, b)
    sources = [s[1] for s in port if s[0] == "ask"]
    # The script reaches every path: startup, a miss, ready-queue hits, and
    # each shed rung.
    assert {"coalesced", "ready_queue", "reject", "independent", "stale_queue"} <= set(sources)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_shed_ladder_equals_the_references(scale):
    critical = scale < 1.0
    policies = {
        name: _ss(pkg).ShedPolicy(
            degrade_depth=4, independent_depth=8, reject_depth=12,
            findings_source=(lambda: ("sampler.fallback_storm",)) if critical else None,
            slo_source=lambda: (), clock=ScriptedClock(),
        )
        for name, pkg in PKGS.items()
    }
    grid = [(depth, stale) for depth in range(0, 15) for stale in (0, 3)]
    got = {name: [p.decide(depth, stale) for depth, stale in grid] for name, p in policies.items()}
    assert got["port"] == got["ref"]
    assert set(got["port"]) == {None, *SHED_POLICIES}
    with pytest.raises(ValueError):
        ShedPolicy(degrade_depth=5, independent_depth=4)


def test_coalescer_window_takes_the_references_batches_on_a_scripted_clock():
    """Full batches leave at once; a short one waits out the window on the
    scripted clock (each read moves it 0.3 s): the same reads, the same
    batches, in both packages."""

    def batches(pkg):
        ss = _ss(pkg)
        reads = []

        def clock():
            reads.append(0.3 * len(reads))
            return reads[-1]

        coalescer = ss._AskCoalescer(window_s=1.0, max_batch=4, clock=clock)
        coalescer._pending = [ss._PendingAsk(i, i) for i in range(10)]
        out = []
        while coalescer._pending:
            out.append([item.number for item in coalescer._collect()])
        return out, len(reads)

    port, ref = batches(optuna_tpu_torch), batches(optuna_tpu)
    assert port == ref and port[0] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_ready_queue_epochs_equal_the_references():
    rng = np.random.RandomState(0)
    ops = rng.randint(0, 7, size=200)
    logs = {}
    for name, pkg in PKGS.items():
        ss = _ss(pkg)
        queue = ss._ReadyQueue(maxlen=6)
        log = []
        for k, op in enumerate(ops):
            if op == 0:
                queue.refill([ss._ReadyEntry({"x": k + j}, {}, queue.epoch) for j in range(3)])
            elif op == 1:
                queue.push_fresh([ss._ReadyEntry({"x": -k}, {}, queue.epoch)])
            elif op == 2:
                queue.invalidate()
            elif op == 3:
                e = queue.pop_fresh(1)
                log.append(None if e is None else (e.params, e.epoch))
            elif op == 4:
                e = queue.pop_any()
                log.append(None if e is None else (e.params, e.epoch))
            log.append((len(queue), queue.fresh_len(0), queue.fresh_len(1), queue.stale_len(1), queue.epoch))
        logs[name] = log
    assert logs["port"] == logs["ref"]


# --------------------------------------------------------- the port's contract


def _stack(storage, factory, **kwargs):
    kwargs.setdefault("health_reporting", False)
    service = SuggestService(storage, factory, **kwargs)
    mounted, rpc = mount(optuna_tpu_torch, storage, service)
    optuna_tpu_torch.create_study(storage=mounted, study_name="served", load_if_exists=True)
    return service, mounted, rpc


def test_burst_of_concurrent_asks_is_one_dispatch_of_distinct_proposals():
    """Four threads ask at once under a frozen clock: the leader waits for
    the batch to fill (never for the wall clock), one width-4 dispatch
    answers all four, and the proposals are the stub's four draws."""
    samplers = []

    def factory():
        samplers.append(stub_sampler(optuna_tpu_torch, seed=3, startup=0))
        return samplers[-1]

    storage = InMemoryStorage()
    service, mounted, rpc = _stack(
        storage, factory, coalesce_window_s=30.0, max_coalesce=4, ready_ahead=0, clock=ScriptedClock()
    )
    study = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=RandomSampler(seed=0))
    trials = [study.ask() for _ in range(4)]
    out: dict = {}

    def ask(trial):
        out[trial.number] = rpc("service_ask", study._study_id, trial._trial_id, trial.number, __op_token=f"t{trial.number}")

    threads = [threading.Thread(target=ask, args=(t,)) for t in trials]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    service.close()
    assert not any(t.is_alive() for t in threads)
    assert samplers[0].widths == [4]
    proposals = {tuple(sorted(r["params"].items())) for r in out.values()}
    want = stub_sampler(optuna_tpu_torch, seed=3)
    assert proposals == {tuple(sorted(want._draw({"x": 0, "y": 0}).items())) for _ in range(4)}
    assert {r["source"] for r in out.values()} == {"coalesced"}
    assert telemetry.snapshot()["gauges"]["serve.coalesce.width.max"] == 4


def _tpe_factory():
    return TPESampler(multivariate=True, n_startup_trials=4, seed=11, device="cpu")


@pytest.mark.parametrize("backend", ["inmemory", "rdb", "journal"])
def test_sequential_thin_client_equals_the_local_study(backend, tmp_path):
    """ready_ahead=0 and one client: every ask is a lone width-1 ask, the
    exact ``sample_relative`` a local sampler runs, so the trials are the
    local TPE study's bit for bit."""
    from optuna_tpu_torch.storages import JournalFileBackend, JournalStorage, RDBStorage

    def make(tag):
        if backend == "rdb":
            return RDBStorage(f"sqlite:///{tmp_path / (tag + '.db')}")
        if backend == "journal":
            return JournalStorage(JournalFileBackend(str(tmp_path / (tag + ".journal"))))
        return InMemoryStorage()

    local = optuna_tpu_torch.create_study(storage=make("local"), sampler=_tpe_factory())
    local.optimize(serve_objective, n_trials=12)
    service, mounted, rpc = _stack(make("served"), _tpe_factory, ready_ahead=0)
    sampler = ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), independent_sampler=_tpe_factory())
    served = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=sampler)
    served.optimize(serve_objective, n_trials=12)
    service.close()
    assert [t.params for t in served.trials] == [t.params for t in local.trials]
    assert [t.value for t in served.trials] == [t.value for t in local.trials]
    assert list(sampler.served_sources) == ["coalesced"] * 12


def test_service_ask_replays_its_op_token_exactly_once():
    samplers = []

    def factory():
        samplers.append(stub_sampler(optuna_tpu_torch, seed=0, startup=0))
        return samplers[-1]

    service, mounted, rpc = _stack(InMemoryStorage(), factory, ready_ahead=0)
    study = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=RandomSampler(seed=0))
    trial = study.ask()
    answers = [rpc("service_ask", study._study_id, trial._trial_id, trial.number, __op_token="same") for _ in range(3)]
    service.close()
    assert answers[0] == answers[1] == answers[2]
    assert samplers[0].widths == [1]
    assert telemetry.snapshot()["counters"]["grpc.op_token_dedup"] == 2


def test_thin_client_degrades_against_a_storage_only_server():
    storage = InMemoryStorage()
    mounted, rpc = mount(optuna_tpu_torch, storage)
    optuna_tpu_torch.create_study(storage=mounted, study_name="served")
    sampler = ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), seed=0)
    study = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=sampler)
    study.optimize(serve_objective, n_trials=3)
    twin = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    twin.optimize(serve_objective, n_trials=3)
    assert sampler._service_unsupported and not sampler.served_sources
    assert [t.params for t in study.trials] == [t.params for t in twin.trials]


def test_server_side_fallback_attr_round_trips_to_the_client():
    """An ordinary sampler error is contained server side: the width-1 ask
    degrades, GuardedSampler writes ``sampler_fallback:relative`` on the
    served trial, and the client reads it through the storage it shares."""
    service, mounted, rpc = _stack(
        InMemoryStorage(),
        lambda: stub_sampler(optuna_tpu_torch, seed=0, startup=0, fail_with=ValueError("poisoned fit")),
        ready_ahead=0,
    )
    sampler = ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), seed=0)
    study = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=sampler)
    study.optimize(serve_objective, n_trials=2)
    service.close()
    assert all(t.state == optuna_tpu_torch.trial.TrialState.COMPLETE for t in study.trials)
    attrs = [t.system_attrs.get("sampler_fallback:relative", "") for t in study.trials]
    assert all("poisoned fit" in a for a in attrs)


def test_drain_flushes_the_open_window_and_rejects_new_asks():
    clock = ScriptedClock()
    service, mounted, rpc = _stack(
        InMemoryStorage(), lambda: stub_sampler(optuna_tpu_torch, seed=0, startup=0),
        coalesce_window_s=30.0, max_coalesce=8, ready_ahead=0, clock=clock,
    )
    study = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=RandomSampler(seed=0))
    parked = study.ask()
    out = {}
    thread = threading.Thread(
        target=lambda: out.setdefault("r", rpc("service_ask", study._study_id, parked._trial_id, parked.number))
    )
    thread.start()
    handle = None
    while handle is None or handle.coalescer.depth == 0:  # the asker parks, waiting on a frozen window
        handle = service._handles.get(study._study_id)
        thread.join(timeout=0.01)
    service.drain()
    thread.join(timeout=60.0)
    assert not thread.is_alive() and out["r"]["source"] == "coalesced" and out["r"]["params"]
    late = study.ask()
    assert rpc("service_ask", study._study_id, late._trial_id, late.number)["shed"] == "reject"
    service.close()


def test_the_service_is_the_autopilots_shed_target():
    from optuna_tpu_torch import autopilot

    service = SuggestService(InMemoryStorage(), lambda: stub_sampler(optuna_tpu_torch), health_reporting=False)
    assert autopilot._noted_service() is service
    undo = autopilot._shed_earlier(service)
    assert service.shed_policy.reject_depth == 64 and service.ready_ahead == 16
    undo()
    assert service.shed_policy.reject_depth == 128 and service.ready_ahead == 8


class _FittedStub:
    """A stub that also exports and restores a fitted state."""

    def __init__(self) -> None:
        self.inner = stub_sampler(optuna_tpu_torch, seed=0, startup=0)
        self.restored = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def export_fitted_state(self):
        return {"kernel_params_cache": {("x",): [np.arange(3.0)]}}

    def restore_fitted_state(self, state):
        self.restored = state
        return True


def test_hub_checkpoint_lands_every_checkpoint_every_tells():
    from optuna_tpu_torch import checkpoint

    storage = InMemoryStorage()
    service, mounted, rpc = _stack(storage, _FittedStub, ready_ahead=0, checkpoint_every=3)
    sampler = ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), seed=0)
    study = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=sampler)
    study.optimize(serve_objective, n_trials=7)
    service.close()
    record = checkpoint.load_checkpoint(storage, study._study_id, "hub")
    assert record is not None and record.n_told == 6 and record.seq == 1
    assert record.state["epoch"] == 1  # invalidate_after=4: the fourth tell bumped it
    assert list(record.state["sampler"]["kernel_params_cache"]) == [("x",)]


# --------------------------------------------------------------- device faults

CUDA_FAULT = "CUDA error: an illegal memory access was encountered"


def test_a_device_fault_in_a_dispatch_is_answered_as_an_error_and_raised_by_the_client():
    service, mounted, rpc = _stack(
        InMemoryStorage(),
        lambda: stub_sampler(optuna_tpu_torch, startup=0, fail_with=RuntimeError(CUDA_FAULT)),
        ready_ahead=0,
    )
    study = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=RandomSampler(seed=0))
    trial = study.ask()
    with pytest.raises(RuntimeError, match="CUDA error"):
        rpc("service_ask", study._study_id, trial._trial_id, trial.number)
    sampler = ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), seed=0)
    client = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=sampler)
    with pytest.raises(RuntimeError, match="CUDA error"):
        client.ask()
    service.close()
    # Nothing was degraded on the way: no fallback attr, no contained count.
    assert not any(k.startswith("sampler_fallback:") for t in study.get_trials() for k in t.system_attrs)
    assert not any(k.startswith("sampler.fallback") for k in telemetry.snapshot()["counters"])


def test_a_kernel_build_fault_on_the_hub_is_raised_by_the_client_not_sampled_around():
    """K1's library failing to build or load on the hub (``KernelBuildError``,
    whose message names no CUDA error) reaches the client as that type, and
    the thin client raises it instead of sampling the trial independently."""
    from optuna_tpu_torch.ops.kernels._nvcc import KernelBuildError

    fault = KernelBuildError("nvcc failed on matern52_gram.cu")
    service, mounted, rpc = _stack(
        InMemoryStorage(), lambda: stub_sampler(optuna_tpu_torch, startup=0, fail_with=fault), ready_ahead=0
    )
    sampler = ThinClientSampler(thin_ask(optuna_tpu_torch, rpc), seed=0)
    client = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=sampler)
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        client.ask()
    service.close()
    trials = client.get_trials()
    assert not any(k.startswith("sampler_fallback:") for t in trials for k in t.system_attrs)
    assert not any(t.params for t in trials)  # nothing was sampled around the fault
    assert not sampler.served_sources  # the hub answered no proposal


def test_a_device_fault_in_the_refill_worker_is_raised_on_the_next_ask():
    raised = threading.Event()

    class Faulty:
        def __init__(self):
            self.inner = stub_sampler(optuna_tpu_torch, startup=0)

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def sample_relative_batch(self, study, search_space, batch_size):
            raised.set()
            raise RuntimeError(CUDA_FAULT)

    service, mounted, rpc = _stack(InMemoryStorage(), Faulty, ready_ahead=4)
    study = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=RandomSampler(seed=0))
    first = study.ask()
    # A lone miss is a width-1 ask (sample_relative: fine); its demand
    # refill runs on the worker thread and hits the fault there.
    assert rpc("service_ask", study._study_id, first._trial_id, first.number)["source"] == "coalesced"
    assert raised.wait(timeout=60.0)
    service.close()  # joins the worker: the fault is parked by now
    second = study.ask()
    with pytest.raises(RuntimeError, match="CUDA error"):
        rpc("service_ask", study._study_id, second._trial_id, second.number)
    assert service._refill_faults == {}  # raised once, not again


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_config2_gp_served_from_the_card_equals_the_local_study(cuda_device):  # noqa: F811
    """Phase 35(a) at a smaller history: a sequential thin client served by
    a hub whose GPSampler runs on the card, past ``n_exact_max`` (SGPR, K1
    once an ask), equals a local ``GPSampler(seed=0)`` study on the same
    history trial for trial."""
    import chip_smoke
    from optuna_tpu_torch.models.benchmarks import hartmann20
    from optuna_tpu_torch.ops.kernels import matern
    from optuna_tpu_torch.samplers import GPSampler

    history = chip_smoke.history_trials(80)
    factory = lambda: GPSampler(seed=0, n_exact_max=64, n_inducing=32)  # noqa: E731
    local = optuna_tpu_torch.create_study(sampler=factory())
    local.add_trials(history)
    local.optimize(hartmann20, n_trials=2)
    service, mounted, ask = chip_smoke.serve_stack(InMemoryStorage(), factory, ready_ahead=0)
    optuna_tpu_torch.create_study(study_name="served", storage=mounted, sampler=RandomSampler()).add_trials(history)
    sampler = ThinClientSampler(ask, seed=0)
    served = optuna_tpu_torch.load_study(study_name="served", storage=mounted, sampler=sampler)
    before = matern.LAUNCHES
    served.optimize(hartmann20, n_trials=2)
    service.close()
    assert matern.LAUNCHES - before == 2 and len(ask.seconds) == 2
    assert [t.params for t in served.trials[80:]] == [t.params for t in local.trials[80:]]
