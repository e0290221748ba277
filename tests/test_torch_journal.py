"""The port's journal storages (``optuna_tpu_torch/storages/journal``) on the
CPU, against the reference.

- The same op sequence, drawn from a NumPy seed, through both packages'
  ``JournalStorage`` (over a journal file and over the fake Redis) gives
  equal ``FrozenTrial`` fields.
- A journal log written by either package replays in the other, which
  then keeps appending to it. Snapshots are left out: they pickle package
  classes.
- The file backend's contract, ported from the reference's
  ``tests/test_storages.py`` (two workers on one file, a torn write, a
  corrupt mid-file record, the snapshot round trip and its CRC and
  version-drift rejections), ``tests/test_redis_journal.py`` (the Redis
  backend through the fake client) and the filesystem chaos of
  ``tests/test_fault_injection.py`` (``tear_journal_tail`` recovery,
  ``plant_stale_lock`` takeover in both lock flavours, a live lock not
  stolen, a stale lock not wedging a study).
- The storage URLs: ``journal://`` and ``*.journal`` resolve to the file
  journal, ``sqlite://`` to the cached RDB storage, and ``grpc://`` to the cached
  gRPC proxy (a port that is not a number raises).
"""

from __future__ import annotations

import json
import time

import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch import telemetry
from optuna_tpu_torch.samplers import RandomSampler
from optuna_tpu_torch.storages.journal import (
    JournalFileBackend,
    JournalFileOpenLock,
    JournalFileSymlinkLock,
    JournalRedisBackend,
    JournalStorage,
)
from optuna_tpu_torch.study import StudyDirection
from optuna_tpu_torch.testing._fake_redis import FakeRedis, flush_all
from optuna_tpu_torch.testing.fault_injection import plant_stale_lock, tear_journal_tail
from optuna_tpu_torch.trial import TrialState
from tests._torch_port import assert_same_trials, run_op_sequence

for _pkg in (optuna_tpu, optuna_tpu_torch):
    _pkg.logging.set_verbosity(_pkg.logging.WARNING)


def _study(storage, name=None):
    return optuna_tpu_torch.create_study(storage=storage, study_name=name, sampler=RandomSampler(seed=0))


@pytest.fixture(autouse=True)
def _clean_redis():
    flush_all()
    yield
    flush_all()


@pytest.fixture
def registry():
    """A fresh telemetry registry, enabled for one test; the previous one
    (and its on/off state) is restored after."""
    saved, was_enabled = telemetry.get_registry(), telemetry.enabled()
    fresh = telemetry.MetricsRegistry()
    telemetry.enable(fresh)
    yield fresh
    telemetry.enable(saved)
    if not was_enabled:
        telemetry.disable()


def _redis_backend(url="redis://localhost:6379/0", prefix="t"):
    return JournalRedisBackend(url, prefix=prefix, client=FakeRedis.from_url(url))


# ------------------------------------------------------- against the reference


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_sequence_matches_the_reference_over_a_file(tmp_path, seed):
    from optuna_tpu.storages.journal import JournalFileBackend as RefBackend
    from optuna_tpu.storages.journal import JournalStorage as RefJournalStorage

    ref_out = run_op_sequence(optuna_tpu, RefJournalStorage(RefBackend(str(tmp_path / "ref.journal"))), seed)
    port_out = run_op_sequence(optuna_tpu_torch, JournalStorage(JournalFileBackend(str(tmp_path / "port.journal"))), seed)
    assert_same_trials(ref_out, port_out)
    assert port_out["study_user_attrs"] == ref_out["study_user_attrs"]


@pytest.mark.parametrize("seed", [3, 4])
def test_op_sequence_matches_the_reference_over_redis(seed):
    from optuna_tpu.storages.journal import JournalRedisBackend as RefBackend
    from optuna_tpu.storages.journal import JournalStorage as RefJournalStorage
    from optuna_tpu.testing._fake_redis import FakeRedis as RefFakeRedis

    url = "redis://localhost:6379/0"
    ref = RefJournalStorage(RefBackend(url, prefix="ref", client=RefFakeRedis.from_url(url)))
    ref_out = run_op_sequence(optuna_tpu, ref, seed)
    port_out = run_op_sequence(optuna_tpu_torch, JournalStorage(_redis_backend(prefix="port")), seed)
    assert_same_trials(ref_out, port_out)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_log_replays_in_the_other_package(tmp_path, writer):
    from optuna_tpu.storages.journal import JournalFileBackend as RefBackend
    from optuna_tpu.storages.journal import JournalStorage as RefJournalStorage

    path = str(tmp_path / "shared.journal")
    make = {
        "reference": (optuna_tpu, lambda: RefJournalStorage(RefBackend(path))),
        "port": (optuna_tpu_torch, lambda: JournalStorage(JournalFileBackend(path))),
    }
    reader = "port" if writer == "reference" else "reference"
    written = run_op_sequence(make[writer][0], make[writer][1](), 5)
    read_storage = make[reader][1]()
    sid = read_storage.get_study_id_from_name(written["study_name"])
    assert read_storage.get_study_user_attrs(sid) == written["study_user_attrs"]
    assert read_storage.get_study_system_attrs(sid) == written["study_system_attrs"]
    assert_same_trials(written, {"trials": read_storage.get_all_trials(sid)})
    # The reader appends to the writer's log, and the writer replays it.
    pkg = make[reader][0]
    study = pkg.load_study(study_name=written["study_name"], storage=read_storage, sampler=pkg.samplers.RandomSampler(seed=0))
    study.optimize(lambda t: t.suggest_float("extra", 0.0, 1.0), n_trials=2)
    assert len(make[writer][1]().get_all_trials(sid)) == len(written["trials"]) + 2


def test_a_log_line_is_the_same_json_in_both_packages(tmp_path):
    """The op payloads match key for key (the worker ids and timestamps
    aside), so a log's format is shared, not merely readable."""
    from optuna_tpu.storages.journal import JournalFileBackend as RefBackend
    from optuna_tpu.storages.journal import JournalStorage as RefJournalStorage

    lines = {}
    for name, pkg, storage in (
        ("ref", optuna_tpu, RefJournalStorage(RefBackend(str(tmp_path / "r.journal")))),
        ("port", optuna_tpu_torch, JournalStorage(JournalFileBackend(str(tmp_path / "p.journal")))),
    ):
        sid = storage.create_new_study([pkg.study.StudyDirection.MINIMIZE], study_name="s")
        tid = storage.create_new_trial(sid)
        storage.set_trial_param(tid, "x", 0.25, pkg.distributions.FloatDistribution(0.0, 1.0))
        storage.set_trial_state_values(tid, pkg.trial.TrialState.COMPLETE, [0.5])
        with open(tmp_path / ("r.journal" if name == "ref" else "p.journal")) as f:
            lines[name] = [json.loads(line) for line in f]
    volatile = {"wid", "datetime", "datetime_start"}
    strip = [[{k: v for k, v in op.items() if k not in volatile} for op in lines[n]] for n in ("ref", "port")]
    assert strip[0] == strip[1]


# --------------------------------------------------------------- file backend


def test_two_workers_on_one_file(tmp_path):
    path = str(tmp_path / "w.journal")
    s1 = JournalStorage(JournalFileBackend(path))
    s2 = JournalStorage(JournalFileBackend(path))
    study = optuna_tpu_torch.create_study(study_name="shared", storage=s1, sampler=RandomSampler(seed=1))
    study2 = optuna_tpu_torch.create_study(
        study_name="shared", storage=s2, sampler=RandomSampler(seed=2), load_if_exists=True
    )
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=5)
    study2.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=5)
    assert len(study.trials) == 10
    assert sorted(t.number for t in study2.trials) == list(range(10))


def test_torn_write_is_ignored_and_healed(tmp_path):
    path = str(tmp_path / "torn.journal")
    backend = JournalFileBackend(path)
    backend.append_logs([{"op": 1, "a": 1}, {"op": 2, "a": 2}])
    with open(path, "ab") as f:
        f.write(b'{"op": 3, "a"')
    assert [log["op"] for log in backend.read_logs(0)] == [1, 2]
    JournalFileBackend(path).append_logs([{"op": 4, "a": 4}])
    logs = JournalFileBackend(path).read_logs(0)
    assert [log["op"] for log in logs] == [1, 2, 4]


def test_corrupt_record_keeps_replay_in_lockstep(tmp_path):
    path = str(tmp_path / "c.journal")
    s1 = JournalStorage(JournalFileBackend(path))
    study_id = s1.create_new_study([StudyDirection.MINIMIZE], "c")
    with open(path, "ab") as f:
        f.write(b'{"op": 4, "wid"')  # torn CREATE_TRIAL
    s1.create_new_trial(study_id)  # heals the tail; the torn record is skipped
    assert s1.get_n_trials(study_id) == 1
    s2 = JournalStorage(JournalFileBackend(path))
    assert s2.get_n_trials(s2.get_study_id_from_name("c")) == 1


def test_snapshot_round_trip_and_rejections(tmp_path, monkeypatch, registry):
    import optuna_tpu_torch.storages.journal._storage as js
    from optuna_tpu_torch.storages.journal._file import frame_snapshot

    monkeypatch.setattr(js, "SNAPSHOT_INTERVAL", 2)
    path = str(tmp_path / "snap.journal")
    s = JournalStorage(JournalFileBackend(path))
    for i in range(4):
        s.create_new_study([StudyDirection.MINIMIZE], f"st{i}")
    assert JournalFileBackend(path).load_snapshot() is not None
    assert len(JournalStorage(JournalFileBackend(path)).get_all_studies()) == 4

    # Garbage without the frame, a bit-flipped frame, and a CRC-valid pickle
    # of a module that does not exist all degrade to full replay.
    with open(path + ".snapshot", "wb") as f:
        f.write(b"\x80\x04garbage-that-would-crash-unpickling")
    assert JournalFileBackend(path).load_snapshot() is None
    assert len(JournalStorage(JournalFileBackend(path)).get_all_studies()) == 4
    framed = bytearray(frame_snapshot(b"payload-bytes"))
    framed[-1] ^= 0xFF
    with open(path + ".snapshot", "wb") as f:
        f.write(bytes(framed))
    assert JournalFileBackend(path).load_snapshot() is None
    JournalFileBackend(path).save_snapshot(b"coptuna_tpu_torch.no_such_module\nNoSuchClass\n.")
    assert len(JournalStorage(JournalFileBackend(path)).get_all_studies()) == 4
    assert registry.snapshot()["counters"]["journal.snapshot_rejected"] == 4


def test_contended_lock_is_counted(tmp_path, registry):
    import os
    import threading

    path = str(tmp_path / "busy.journal")
    backend = JournalFileBackend(path)
    lockfile = plant_stale_lock(path, age_s=0.0)  # a live holder, released soon
    holder = threading.Timer(0.05, os.unlink, args=(lockfile,))
    holder.start()
    backend.append_logs([{"op": 1}])
    holder.join(timeout=5.0)
    assert not holder.is_alive()
    # Counted once per contended acquire, however many polls it took.
    assert registry.snapshot()["counters"]["journal.lock_contention"] == 1
    assert backend.read_logs(0) == [{"op": 1}]


# ------------------------------------------------------------ filesystem chaos


def test_torn_journal_tail_replays_cleanly_and_heals(tmp_path):
    path = str(tmp_path / "study.journal")
    study = _study(JournalStorage(JournalFileBackend(path)))
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=5)
    n = len(study.trials)
    assert tear_journal_tail(path) > 0
    survivor = optuna_tpu_torch.load_study(
        study_name=study.study_name, storage=JournalStorage(JournalFileBackend(path)), sampler=RandomSampler(seed=1)
    )
    assert len(survivor.trials) == n
    assert sum(t.state == TrialState.COMPLETE for t in survivor.trials) == n - 1
    survivor.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=2)
    final = optuna_tpu_torch.load_study(study_name=study.study_name, storage=JournalStorage(JournalFileBackend(path)))
    assert len(final.trials) == n + 2


def test_torn_tail_left_by_the_port_replays_in_the_reference(tmp_path):
    from optuna_tpu.storages.journal import JournalFileBackend as RefBackend
    from optuna_tpu.storages.journal import JournalStorage as RefJournalStorage

    path = str(tmp_path / "x.journal")
    study = _study(JournalStorage(JournalFileBackend(path)), name="x")
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=4)
    tear_journal_tail(path)
    ref = RefJournalStorage(RefBackend(path))
    port = JournalStorage(JournalFileBackend(path))
    sid = port.get_study_id_from_name("x")
    assert_same_trials({"trials": ref.get_all_trials(sid)}, {"trials": port.get_all_trials(sid)})


@pytest.mark.parametrize("flavor,lock_cls", [("symlink", JournalFileSymlinkLock), ("open", JournalFileOpenLock)])
def test_stale_lock_taken_over_within_grace(tmp_path, flavor, lock_cls):
    path = str(tmp_path / "locked.journal")
    open(path, "w").close()
    plant_stale_lock(path, age_s=3600.0, flavor=flavor)
    lock = lock_cls(path, grace_period=5.0)
    t0 = time.monotonic()
    assert lock.acquire()
    assert time.monotonic() - t0 < 5.0  # stole the stale lock, did not wait it out
    lock.release()


def test_fresh_lock_is_not_stolen(tmp_path):
    path = str(tmp_path / "held.journal")
    open(path, "w").close()
    plant_stale_lock(path, age_s=0.0)  # a live holder's lock
    lock = JournalFileSymlinkLock(path, grace_period=30.0)
    lock._ACQUIRE_TIMEOUT = 0.5
    with pytest.raises(TimeoutError):
        lock.acquire()


def test_stale_lock_does_not_wedge_a_real_study(tmp_path):
    path = str(tmp_path / "wedged.journal")
    open(path, "w").close()
    plant_stale_lock(path, age_s=3600.0)
    lock = JournalFileSymlinkLock(path, grace_period=2.0)
    study = _study(JournalStorage(JournalFileBackend(path, lock_obj=lock)))
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=3)
    assert len(study.trials) == 3


def test_plant_stale_lock_rejects_an_unknown_flavor(tmp_path):
    with pytest.raises(ValueError, match="flavor"):
        plant_stale_lock(str(tmp_path / "f.journal"), flavor="flock")


# --------------------------------------------------------------- Redis backend


def test_redis_append_and_incremental_read():
    b = _redis_backend()
    b.append_logs([{"op": 1}, {"op": 2}])
    b.append_logs([{"op": 3}])
    assert b.read_logs(0) == [{"op": 1}, {"op": 2}, {"op": 3}]
    assert b.read_logs(2) == [{"op": 3}]
    assert b.read_logs(3) == []


def test_redis_snapshot_round_trip_and_prefixes():
    b = _redis_backend()
    assert b.load_snapshot() is None
    b.save_snapshot(b"state-blob")
    assert b.load_snapshot() == b"state-blob"
    shared = _redis_backend(prefix="shared")
    shared.append_logs([{"op": 9}])
    assert _redis_backend(prefix="shared").read_logs(0) == [{"op": 9}]
    assert _redis_backend(prefix="other").read_logs(0) == []


def test_redis_study_runs_and_reloads():
    storage = JournalStorage(_redis_backend(prefix="study"))
    study = _study(storage, name="redis-study")
    study.optimize(lambda t: (t.suggest_float("x", -1, 1)) ** 2, n_trials=8)
    reloaded = optuna_tpu_torch.load_study(storage=JournalStorage(_redis_backend(prefix="study")), study_name="redis-study")
    assert len(reloaded.trials) == 8
    assert reloaded.best_value == study.best_value


def test_redis_backend_without_the_package_raises_with_guidance(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "redis", None)
    with pytest.raises(ImportError, match="JournalFileBackend"):
        JournalRedisBackend("redis://localhost:6379/0")


# ---------------------------------------------------------------- storage URLs


@pytest.mark.parametrize("form", ["journal://", "suffix"])
def test_journal_urls_run_and_reload_a_study(tmp_path, form):
    path = str(tmp_path / "u.journal")
    url = f"journal://{path}" if form == "journal://" else path
    study = _study(url, name="u")
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=3)
    assert isinstance(study._storage, JournalStorage)
    reloaded = optuna_tpu_torch.load_study(study_name="u", storage=url)
    assert [t.params for t in reloaded.trials] == [t.params for t in study.trials]


def test_sqlite_url_runs_and_reloads_through_the_cache(tmp_path):
    from optuna_tpu_torch.storages import RDBStorage, _CachedStorage

    url = f"sqlite:///{tmp_path / 'u.db'}"
    study = _study(url, name="u")
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=3)
    assert isinstance(study._storage, _CachedStorage)
    assert isinstance(study._storage._backend, RDBStorage)
    reloaded = optuna_tpu_torch.load_study(study_name="u", storage=url)
    assert reloaded.best_value == study.best_value


def test_grpc_url_raises_naming_the_roadmap_item():
    # What still raises: a URL with no backend, and a gRPC URL whose port is
    # not a number (parsed before a channel is built: no grpc needed).
    with pytest.raises(ValueError, match="Unrecognized"):
        optuna_tpu_torch.storages.get_storage("ftp://nowhere")
    with pytest.raises(ValueError):
        optuna_tpu_torch.storages.get_storage("grpc://localhost:notaport")


def test_grpc_url_resolves_to_the_cached_proxy():
    from optuna_tpu_torch.storages import GrpcStorageProxy, _CachedStorage

    pytest.importorskip("grpc")
    storage = optuna_tpu_torch.storages.get_storage("grpc://localhost:13000")  # the channel dials lazily
    assert isinstance(storage, _CachedStorage) and isinstance(storage._backend, GrpcStorageProxy)
    storage._backend.remove_session()
