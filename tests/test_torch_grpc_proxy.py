"""The port's gRPC storage proxy over real loopback sockets.

Every server here listens on a free loopback port and is stopped in a
``finally``; every thread is joined with a timeout. The two packages share
one wire (``tests/test_torch_grpc_wire.py``), so a port
``GrpcStorageProxy`` drives the reference's ``make_grpc_server`` and a
reference proxy drives the port's, over one journal file: the records each
writes and the other reads back are equal field for field. The storage
contract kit runs in the two ``grpc_*`` modes in
``tests/test_torch_storage_contract.py``.
"""

from __future__ import annotations

import pickle
import random
import threading

import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch import telemetry
from optuna_tpu_torch.samplers import RandomSampler
from optuna_tpu_torch.storages import InMemoryStorage, RetryPolicy
from optuna_tpu_torch.storages._grpc._service import OP_TOKEN_KEY
from optuna_tpu_torch.storages._grpc.client import GrpcStorageProxy, is_transport_unavailable
from optuna_tpu_torch.storages._grpc.server import make_grpc_server
from optuna_tpu_torch.testing.netchaos import NetChaos, NetChaosPlan
from optuna_tpu_torch.testing.storages import _find_free_port
from tests._torch_port import assert_same_trials, run_op_sequence

grpc = pytest.importorskip("grpc")


@pytest.fixture(autouse=True)
def _registry():
    telemetry.enable(telemetry.MetricsRegistry())
    yield
    telemetry.disable()


def _serve(make_server, storage):
    port = _find_free_port()
    server = make_server(storage, "localhost", port, thread_pool_size=4)
    server.start()
    return server, port


def _journal(pkg, path):
    from importlib import import_module

    journal = import_module(pkg.__name__ + ".storages.journal")
    return journal.JournalStorage(journal.JournalFileBackend(str(path)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("server_pkg", ["ref", "port"])
def test_cross_package_proxy_and_server_over_one_journal(tmp_path, server_pkg, seed):
    """A client of one package writes a seeded op sequence through the other
    package's server into a journal file; the same sequence written
    directly by the client's package, and the file read back by both
    packages, give equal records."""
    from optuna_tpu.storages._grpc.client import GrpcStorageProxy as RefProxy
    from optuna_tpu.storages._grpc.server import make_grpc_server as ref_make_server

    path = tmp_path / "served.journal"
    if server_pkg == "ref":
        server_store, make_server = _journal(optuna_tpu, path), ref_make_server
        client_pkg, Proxy = optuna_tpu_torch, GrpcStorageProxy
    else:
        server_store, make_server = _journal(optuna_tpu_torch, path), make_grpc_server
        client_pkg, Proxy = optuna_tpu, RefProxy
    server, port = _serve(make_server, server_store)
    proxy = Proxy(host="localhost", port=port)
    try:
        served = run_op_sequence(client_pkg, proxy, seed)
    finally:
        proxy.remove_session()
        server.stop(None)
    direct = run_op_sequence(client_pkg, _journal(client_pkg, tmp_path / "direct.journal"), seed)
    assert served["study_user_attrs"] == direct["study_user_attrs"]
    assert served["study_system_attrs"] == direct["study_system_attrs"]
    assert_same_trials(served, direct)
    for pkg in (optuna_tpu, optuna_tpu_torch):
        reread = _journal(pkg, path)
        sid = reread.get_study_id_from_name(served["study_name"])
        assert_same_trials(served, {"trials": reread.get_all_trials(sid)})


def test_create_study_on_a_grpc_url_against_run_grpc_proxy_server(tmp_path, monkeypatch):
    """``create_study(storage="grpc://localhost:<port>")`` against the
    blocking entry point, run on a thread (its signal hooks then stand
    aside); the server is captured to stop it."""
    from optuna_tpu_torch.storages._grpc import server as server_mod

    started: list = []
    real = server_mod.make_grpc_server

    def capture(*args, **kwargs):
        server = real(*args, **kwargs)
        started.append(server)
        return server

    monkeypatch.setattr(server_mod, "make_grpc_server", capture)
    backing = _journal(optuna_tpu_torch, tmp_path / "url.journal")
    port = _find_free_port()
    thread = threading.Thread(
        target=optuna_tpu_torch.storages.run_grpc_proxy_server,
        args=(backing,),
        kwargs={"host": "localhost", "port": port, "thread_pool_size": 4},
        daemon=True,
    )
    thread.start()
    study = None
    try:
        study = optuna_tpu_torch.create_study(
            storage=f"grpc://localhost:{port}", study_name="url", sampler=RandomSampler(seed=0)
        )
        study.optimize(lambda t: (t.suggest_float("x", -1, 1) - 0.5) ** 2, n_trials=6)
        twin = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
        twin.optimize(lambda t: (t.suggest_float("x", -1, 1) - 0.5) ** 2, n_trials=6)
        assert [t.params for t in study.trials] == [t.params for t in twin.trials]
        # Read back past the proxy, by the reference too.
        ref_view = _journal(optuna_tpu, tmp_path / "url.journal")
        sid = ref_view.get_study_id_from_name("url")
        assert [t.value for t in ref_view.get_all_trials(sid)] == [t.value for t in twin.trials]
    finally:
        if study is not None:
            study._storage.remove_session()
        for server in started:
            server.stop(0)
        thread.join(timeout=30.0)
    assert not thread.is_alive()


def test_proxy_retry_is_bounded_and_jittered():
    """Against a dead endpoint the proxy dials exactly ``max_attempts``
    times with full-jitter delays, on an injected clock and sleep."""
    sleeps: list[float] = []
    policy = RetryPolicy(
        max_attempts=3, initial_backoff=0.1, max_backoff=1.0, multiplier=2.0, deadline=60.0,
        sleep=sleeps.append, clock=lambda: 0.0, rng=random.Random(1),
    )
    proxy = GrpcStorageProxy(port=_find_free_port(), retry_policy=policy)
    try:
        with pytest.raises(grpc.RpcError) as info:
            proxy.get_all_studies()
        assert is_transport_unavailable(info.value)
    finally:
        proxy.remove_session()
    assert len(sleeps) == 2 and 0.0 <= sleeps[0] <= 0.1 and 0.0 <= sleeps[1] <= 0.2
    assert telemetry.snapshot()["counters"].get("grpc.redial") == 2


def test_proxy_survives_a_server_restart_between_trials(tmp_path):
    from optuna_tpu_torch.storages._rdb.storage import RDBStorage

    url = f"sqlite:///{tmp_path}/restart.db"
    port = _find_free_port()
    server = make_grpc_server(RDBStorage(url), "localhost", port)
    server.start()
    proxy = GrpcStorageProxy(
        port=port,
        retry_policy=RetryPolicy(max_attempts=20, initial_backoff=0.05, max_backoff=0.25, deadline=30.0),
    )
    try:
        study = optuna_tpu_torch.create_study(storage=proxy, study_name="restart", sampler=RandomSampler(seed=1))
        study.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=3)
        server.stop(grace=None)
        server = make_grpc_server(RDBStorage(url), "localhost", port)
        server.start()
        study.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=3)
        assert [t.number for t in study.trials] == list(range(6))
        assert all(t.state.is_finished() for t in study.trials)
    finally:
        proxy.remove_session()
        server.stop(grace=None)


def test_proxy_pickles_without_its_channel():
    storage = InMemoryStorage()
    server, port = _serve(make_grpc_server, storage)
    proxy = GrpcStorageProxy(port=port)
    clone = None
    try:
        sid = proxy.create_new_study([optuna_tpu_torch.study.StudyDirection.MINIMIZE], "p")
        clone = pickle.loads(pickle.dumps(proxy))
        assert clone._channel is not None and clone._channel is not proxy._channel
        assert clone.get_study_name_from_id(sid) == "p"
        assert clone.get_failed_trial_callback() is None
    finally:
        proxy.remove_session()
        if clone is not None:
            clone.remove_session()
        server.stop(0)


def _no_sleep(attempts):
    return RetryPolicy(max_attempts=attempts, sleep=lambda _s: None)


def test_netchaos_drop_on_a_real_channel_is_retried_with_one_token():
    storage = InMemoryStorage()
    sid = storage.create_new_study([optuna_tpu_torch.study.StudyDirection.MINIMIZE], "sock")
    server, port = _serve(make_grpc_server, storage)
    chaos = NetChaos(NetChaosPlan(drop={"create_new_trial": [0]}))
    proxy = chaos.wrap_proxy(GrpcStorageProxy(port=port, retry_policy=_no_sleep(3)))
    try:
        trial_id = proxy.create_new_trial(sid)
        assert storage.get_trial(trial_id).number == 0
        assert len(storage.get_all_trials(sid)) == 1
        assert chaos.injected.get("drop", 0) == 1
    finally:
        proxy.remove_session()
        server.stop(0)


def test_oneway_partition_commits_and_the_same_token_replays():
    storage = InMemoryStorage()
    sid = storage.create_new_study([optuna_tpu_torch.study.StudyDirection.MINIMIZE], "oneway")
    server, port = _serve(make_grpc_server, storage)
    chaos = NetChaos()
    proxy = chaos.wrap_proxy(GrpcStorageProxy(port=port, retry_policy=RetryPolicy(max_attempts=1)))
    try:
        chaos.partition("server", "oneway")
        with pytest.raises(Exception):
            proxy._call("create_new_trial", sid, **{OP_TOKEN_KEY: "tok-oneway"})
        assert len(storage.get_all_trials(sid)) == 1
        chaos.heal("server")
        replayed = proxy._call("create_new_trial", sid, **{OP_TOKEN_KEY: "tok-oneway"})
        assert len(storage.get_all_trials(sid)) == 1 and storage.get_trial(replayed).number == 0
        assert telemetry.snapshot()["counters"].get("grpc.op_token_dedup") == 1
        assert chaos.injected.get("partition_oneway") == 1
    finally:
        proxy.remove_session()
        server.stop(0)


def test_op_token_eviction_inside_the_window_is_counted(monkeypatch):
    """A one-slot replay cache evicts a committed-but-unacked op's token
    inside the retry window: counted on ``grpc.op_token_evicted_live``, and
    the delayed retry re-executes (the double apply the counter pages on)."""
    from optuna_tpu_torch.storages._grpc import server as server_mod

    monkeypatch.setattr(server_mod, "_OP_TOKEN_CACHE_SIZE", 1)
    storage = InMemoryStorage()
    sid = storage.create_new_study([optuna_tpu_torch.study.StudyDirection.MINIMIZE], "evict")
    server, port = _serve(make_grpc_server, storage)
    chaos = NetChaos()
    proxy = chaos.wrap_proxy(GrpcStorageProxy(port=port, retry_policy=RetryPolicy(max_attempts=1)))
    try:
        chaos.partition("server", "oneway")
        with pytest.raises(Exception):
            proxy._call("create_new_trial", sid, **{OP_TOKEN_KEY: "tok-evict"})
        chaos.heal("server")
        proxy.create_new_trial(sid)
        assert telemetry.snapshot()["counters"].get("grpc.op_token_evicted_live", 0) >= 1
        proxy._call("create_new_trial", sid, **{OP_TOKEN_KEY: "tok-evict"})
        assert len(storage.get_all_trials(sid)) == 3
    finally:
        proxy.remove_session()
        server.stop(0)
