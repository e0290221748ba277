"""The storage wrappers of the port against the reference, on the CPU.

- The port's copy of the storage contract
  (``optuna_tpu_torch/testing/pytest_storages.py``) on ``InMemoryStorage``,
  ``_CachedStorage(InMemoryStorage())``, ``RetryingStorage(InMemoryStorage())``
  and, as the reference's ``TestStorageContractUnderFaults`` does, on
  ``RetryingStorage(FaultInjectorStorage(InMemoryStorage(), 5 % transient
  faults))``.
- ``RetryPolicy`` draws the same seeded backoff schedule as the reference's
  and stops on the same attempt and deadline.
- ``RetryingStorage`` over ``FaultInjectorStorage`` completes a RandomSampler
  study under the reference's fault plans, and the study is identical trial
  for trial to the fault-free run of the reference.
"""

from __future__ import annotations

import random
import threading

import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch.storages import (
    InMemoryStorage,
    RetryingStorage,
    RetryPolicy,
    TransientStorageError,
    _CachedStorage,
)
from optuna_tpu_torch.storages._base import _ForwardingStorage
from optuna_tpu_torch.testing.fault_injection import (
    FaultInjectorStorage,
    FaultPlan,
    SimulatedWorkerDeath,
)
from optuna_tpu_torch.testing.pytest_storages import StorageTestCase

PKGS = (optuna_tpu, optuna_tpu_torch)
for _pkg in PKGS:
    _pkg.logging.set_verbosity(_pkg.logging.WARNING)

NO_SLEEP = dict(sleep=lambda _s: None)

MODES = {
    "inmemory": lambda: InMemoryStorage(),
    "cached": lambda: _CachedStorage(InMemoryStorage()),
    "retrying": lambda: RetryingStorage(InMemoryStorage()),
}


class TestStorageContract(StorageTestCase):
    @pytest.fixture(params=sorted(MODES))
    def storage(self, request):
        yield MODES[request.param]()


_FAULTS = {"injected": 0, "fixture_runs": 0}


class TestStorageContractUnderFaults(StorageTestCase):
    @pytest.fixture(params=["inmemory", "cached"])
    def storage(self, request):
        injector = FaultInjectorStorage(
            MODES[request.param](), FaultPlan(transient_rate=0.05, seed=sum(map(ord, request.param)))
        )
        yield RetryingStorage(
            injector, RetryPolicy(max_attempts=25, deadline=None, **NO_SLEEP), retry_non_idempotent=True
        )
        _FAULTS["injected"] += injector.faults_injected
        _FAULTS["fixture_runs"] += 1


def test_fault_matrix_actually_injected():
    """Runs after the class above (file order): the under-faults matrix must
    have injected real faults, or it degraded to a happy-path rerun."""
    if _FAULTS["fixture_runs"] < 2:
        pytest.skip("under-faults matrix not (fully) selected in this run")
    assert _FAULTS["injected"] > 0


# --------------------------------------------------------------- RetryPolicy


def _policies(**kwargs):
    """The reference's policy and the port's, with one seeded rng each."""
    from importlib import import_module

    return [
        import_module(f"{pkg.__name__}.storages._retry").RetryPolicy(rng=random.Random(3), **kwargs)
        for pkg in PKGS
    ]


def test_backoff_schedule_equals_the_reference():
    ref, port = _policies(initial_backoff=0.05, max_backoff=1.0, multiplier=3.0)
    assert [port.backoff_cap(k) for k in range(1, 12)] == [ref.backoff_cap(k) for k in range(1, 12)]
    assert [port.next_delay(k) for k in range(1, 12)] == [ref.next_delay(k) for k in range(1, 12)]
    assert port.backoff_cap(5000) == ref.backoff_cap(5000) == 1.0  # the clamped exponent
    assert port.jitter(0.5) == ref.jitter(0.5)


@pytest.mark.parametrize("fail_times, max_attempts", [(2, 5), (4, 5), (7, 5)])
def test_call_retries_until_success_or_attempts_run_out(fail_times, max_attempts):
    out = []
    for policy in _policies(max_attempts=max_attempts, **NO_SLEEP):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) <= fail_times:
                raise ConnectionResetError("blip")
            return "ok"

        try:
            result = policy.call(flaky)
        except ConnectionResetError:
            result = "raised"
        out.append((result, len(calls)))
    assert out[0] == out[1]
    assert out[1] == (("ok", fail_times + 1) if fail_times < max_attempts else ("raised", max_attempts))


def test_deadline_classifier_and_validation_equal_the_reference():
    from importlib import import_module

    counts = []
    for pkg in PKGS:
        retry = import_module(f"{pkg.__name__}.storages._retry")
        # Start at 0; the retry check after the second failure reads 2.0,
        # past the 1 s deadline once the drawn delay is added.
        clock = iter([0.0, 0.1, 2.0]).__next__
        policy = retry.RetryPolicy(max_attempts=10, deadline=1.0, clock=clock, rng=random.Random(3), **NO_SLEEP)
        calls = []

        def always():
            calls.append(1)
            raise TimeoutError("slow")

        with pytest.raises(TimeoutError):
            policy.call(always)
        counts.append(len(calls))
    assert counts == [2, 2]
    for pkg in PKGS:
        retry = import_module(f"{pkg.__name__}.storages._retry")
        assert not retry.RetryPolicy().is_retryable(ValueError("not transient"))
        assert retry.RetryPolicy(retryable=KeyError).is_retryable(KeyError("x"))
        assert retry.RetryPolicy(retryable=lambda e: "x" in str(e)).is_retryable(ValueError("x"))
        with pytest.raises(ValueError):
            retry.RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            retry.RetryPolicy(multiplier=0.5)
    from optuna_tpu.storages import _retry as ref_retry
    from optuna_tpu_torch.storages import _retry as port_retry

    assert port_retry.REPLAY_UNSAFE_METHODS == ref_retry.REPLAY_UNSAFE_METHODS
    assert port_retry.NON_IDEMPOTENT_METHODS == ref_retry.NON_IDEMPOTENT_METHODS
    assert [e.__name__ for e in port_retry.DEFAULT_RETRYABLE_ERRORS] == [
        e.__name__ for e in ref_retry.DEFAULT_RETRYABLE_ERRORS
    ]


def test_replay_unsafe_chaos_matrix_names_every_replay_unsafe_write():
    from optuna_tpu.testing import fault_injection as ref_fi
    from optuna_tpu_torch.storages._retry import REPLAY_UNSAFE_METHODS
    from optuna_tpu_torch.testing import fault_injection as port_fi

    assert set(port_fi.REPLAY_UNSAFE_CHAOS_MATRIX) == set(REPLAY_UNSAFE_METHODS)
    assert port_fi.REPLAY_UNSAFE_CHAOS_MATRIX == ref_fi.REPLAY_UNSAFE_CHAOS_MATRIX
    plan = port_fi.replay_unsafe_chaos_plan(indices=(0, 2))
    assert {k: tuple(v) for k, v in plan.schedule.items()} == {m: (0, 2) for m in REPLAY_UNSAFE_METHODS}


# ---------------------------------------------------------- RetryingStorage


def _objective(pkg):
    def objective(trial):
        x = trial.suggest_float("x", -2.0, 2.0)
        k = trial.suggest_int("k", 0, 5)
        c = trial.suggest_categorical("c", ["a", "b"])
        trial.set_user_attr("n", trial.number)
        trial.report(x, 0)
        return x * x + k + (c == "b")

    return objective


def _rows(study):
    return [
        (t.number, t.state.name, t.params, t.values, t.intermediate_values, t.user_attrs, t.system_attrs)
        for t in study.get_trials(deepcopy=False)
    ]


def _fault_free_reference(n_trials: int):
    study = optuna_tpu.create_study(sampler=optuna_tpu.samplers.RandomSampler(seed=6))
    study.optimize(_objective(optuna_tpu), n_trials=n_trials)
    return _rows(study)


def _plans():
    from optuna_tpu_torch.testing.fault_injection import replay_unsafe_chaos_plan

    return {
        "transient_10pct": FaultPlan(transient_rate=0.1, seed=7),
        "latency": FaultPlan(latency_rate=0.2, latency_s=0.001, seed=2),
        "replay_unsafe_first_two": replay_unsafe_chaos_plan(indices=(0, 1)),
        "scheduled_reads": FaultPlan(schedule={"get_all_trials": (0, 3, 4), "get_trial": (1, 2)}),
        "capped": FaultPlan(transient_rate=0.5, max_faults=10, seed=1),
    }


@pytest.mark.parametrize("plan_name", sorted(_plans()))
def test_retrying_storage_completes_the_fault_free_study(plan_name):
    injector = FaultInjectorStorage(InMemoryStorage(), _plans()[plan_name])
    storage = RetryingStorage(
        injector, RetryPolicy(max_attempts=20, deadline=None, **NO_SLEEP), retry_non_idempotent=True
    )
    study = optuna_tpu_torch.create_study(storage=storage, sampler=optuna_tpu_torch.samplers.RandomSampler(seed=6))
    study.optimize(_objective(optuna_tpu_torch), n_trials=20)
    assert _rows(study) == _fault_free_reference(20)
    if plan_name != "latency":
        assert injector.faults_injected > 0
    if plan_name == "capped":
        assert injector.faults_injected == 10


def test_replay_unsafe_writes_pass_through_without_the_opt_in():
    injector = FaultInjectorStorage(InMemoryStorage(), FaultPlan(schedule={"create_new_trial": (0,)}))
    storage = RetryingStorage(injector, RetryPolicy(**NO_SLEEP))
    sid = storage.create_new_study([optuna_tpu_torch.StudyDirection.MINIMIZE])
    with pytest.raises(TransientStorageError):
        storage.create_new_trial(sid)
    assert storage.create_new_trial(sid) == 0  # the first call never reached the backend
    # A read under the same wrapper is retried.
    injector.plan = FaultPlan(schedule={"get_trial": (0,)})
    injector.calls.clear()
    assert storage.get_trial(0).number == 0
    assert injector.calls["get_trial"] == 2


def test_a_scheduled_kill_punches_through_and_leaves_the_trial_running():
    injector = FaultInjectorStorage(
        InMemoryStorage(), FaultPlan(kill_schedule={"set_trial_state_values": (1,)})
    )
    storage = RetryingStorage(injector, RetryPolicy(**NO_SLEEP), retry_non_idempotent=True)
    study = optuna_tpu_torch.create_study(storage=storage, sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    with pytest.raises(SimulatedWorkerDeath):
        study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=5)
    assert [t.state.name for t in study.trials] == ["COMPLETE", "RUNNING"]
    assert injector.kills_injected == 1 and not issubclass(SimulatedWorkerDeath, Exception)


def test_retry_counter_and_storage_span():
    from optuna_tpu_torch import telemetry

    registry = telemetry.MetricsRegistry()
    telemetry.enable(registry)
    try:
        injector = FaultInjectorStorage(InMemoryStorage(), FaultPlan(schedule={"get_all_studies": (0, 1)}))
        storage = RetryingStorage(injector, RetryPolicy(**NO_SLEEP))
        storage.get_all_studies()
    finally:
        telemetry.disable()
    snap = registry.snapshot()
    assert snap["counters"]["storage.retry"] == 2
    assert snap["histograms"]["phase.storage.op"]["count"] == 1


# ------------------------------------------------------------ _CachedStorage


class _CountingStorage(InMemoryStorage):
    def __init__(self) -> None:
        super().__init__()
        self.partial_reads: list[tuple[int, frozenset]] = []

    def _read_trials_partial(self, study_id, max_known_trial_id, extra_ids):
        self.partial_reads.append((max_known_trial_id, frozenset(extra_ids)))
        return super()._read_trials_partial(study_id, max_known_trial_id, extra_ids)


def test_cached_storage_reads_only_new_and_unfinished_trials():
    backend = _CountingStorage()
    storage = _CachedStorage(backend)
    study = optuna_tpu_torch.create_study(storage=storage, sampler=optuna_tpu_torch.samplers.RandomSampler(seed=6))
    study.optimize(_objective(optuna_tpu_torch), n_trials=12)
    assert _rows(study) == _fault_free_reference(12)
    running = storage.create_new_trial(study._study_id)
    backend.partial_reads.clear()
    trials = storage.get_all_trials(study._study_id)
    assert len(trials) == 13
    # The watermark is the newest finished trial; the RUNNING one is re-read.
    assert backend.partial_reads == [(11, frozenset({running}))]
    storage.set_trial_state_values(running, optuna_tpu_torch.TrialState.FAIL)
    assert storage.get_all_trials(study._study_id, states=(optuna_tpu_torch.TrialState.FAIL,))[0].number == 12
    assert storage.get_trial(running).state.name == "FAIL"


def test_cached_storage_survives_pickling_and_threads():
    import pickle

    storage = _CachedStorage(InMemoryStorage())
    sid = storage.create_new_study([optuna_tpu_torch.StudyDirection.MINIMIZE])

    def worker():
        for _ in range(10):
            tid = storage.create_new_trial(sid)
            storage.set_trial_state_values(tid, optuna_tpu_torch.TrialState.COMPLETE, [0.0])
            storage.get_all_trials(sid, deepcopy=False)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(t.number for t in storage.get_all_trials(sid)) == list(range(40))
    clone = pickle.loads(pickle.dumps(storage))
    assert len(clone.get_all_trials(sid)) == 40


# ---------------------------------------------------- forwarding + heartbeat


def test_forwarding_wrappers_degrade_heartbeats_on_a_heartbeatless_backend():
    from optuna_tpu_torch.storages._heartbeat import BaseHeartbeat, is_heartbeat_enabled

    for storage in (RetryingStorage(InMemoryStorage()), FaultInjectorStorage(InMemoryStorage())):
        assert isinstance(storage, BaseHeartbeat) and isinstance(storage, _ForwardingStorage)
        assert not is_heartbeat_enabled(storage)
        assert storage.get_heartbeat_interval() is None
        assert storage.get_failed_trial_callback() is None
        assert storage._get_stale_trial_ids(0) == []
        storage.record_heartbeat(0)  # a no-op
        storage.remove_session()


def test_get_storage_keeps_urls_for_the_backends_slice(tmp_path):
    from optuna_tpu_torch.storages import RDBStorage, get_storage

    storage = InMemoryStorage()
    assert get_storage(storage) is storage
    assert isinstance(get_storage(None), InMemoryStorage)
    # The RDB and journal URLs resolve (tests/test_torch_journal.py runs
    # them), and so does the gRPC proxy's (the test below).
    rdb = get_storage(f"sqlite:///{tmp_path / 'study.db'}")
    assert isinstance(rdb, _CachedStorage) and isinstance(rdb._backend, RDBStorage)
    with pytest.raises(ValueError):
        get_storage(3)


def test_get_storage_resolves_the_grpc_url_to_the_cached_proxy():
    from optuna_tpu_torch.storages import GrpcStorageProxy, get_storage

    pytest.importorskip("grpc")
    proxied = get_storage("grpc://localhost:13000")  # the channel dials lazily: no server needed
    assert isinstance(proxied, _CachedStorage) and isinstance(proxied._backend, GrpcStorageProxy)
    proxied._backend.remove_session()
