"""The port's ICI journal against the reference's, on the CPU.

- ``_pack`` gives the reference's bytes for the same logs (the ``uint32``
  length header, compact JSON lines, zero padding), and both refuse an
  overflow before the collective;
- the reference's six ``FakePodBus`` scenarios (``tests/test_ici_multihost.py``)
  run through both packages' buses and give equal merged logs (a
  ``JournalStorage``'s random worker id and its timestamps left out);
- two real ranks (a gloo group, spawned) push distinct ops through the
  real all-gather and derive the same merged log, in (round, rank, local)
  order.
"""

from __future__ import annotations

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu.parallel
import optuna_tpu.testing.fault_injection
import optuna_tpu_torch
import optuna_tpu_torch.parallel
import optuna_tpu_torch.testing.fault_injection
from tests import _torch_mesh_workers as workers
from tests._torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKGS = (optuna_tpu, optuna_tpu_torch)

_LOGS = {
    "empty": [],
    "one": [{"op": 1}],
    "nested": [{"op": 2, "blob": "é∑ ok", "nested": {"a": [1, 2.5, None, True], "b": -0.1}}],
    "many": [{"op": i % 7, "w": i, "v": i / 3.0, "s": "x" * (i % 13)} for i in range(64)],
}


@pytest.mark.parametrize("name", sorted(_LOGS))
def test_pack_gives_the_references_bytes(name):
    logs = _LOGS[name]
    ref = optuna_tpu.parallel.IciJournalBackend(buffer_bytes=8192)
    port = optuna_tpu_torch.parallel.IciJournalBackend(buffer_bytes=8192)
    a, b = ref._pack(logs), port._pack(logs)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (8192,)
    assert a.tobytes() == b.tobytes()
    assert port._unpack(b) == ref._unpack(a) == logs


def test_an_overflow_is_refused_before_the_collective_in_both():
    for pkg in PKGS:
        backend = pkg.parallel.IciJournalBackend(buffer_bytes=256)
        backend._pending.extend([{"blob": "y" * 500}])
        with pytest.raises(ValueError, match="overflow"):
            backend.exchange()
        assert backend._pending  # the oversized ops are still pending


def _masked(logs):
    """A journal's ops without the writer's random id and its timestamps."""
    return [{k: v for k, v in op.items() if k != "wid" and "datetime" not in k} for op in logs]


def _identical_log(pkg):
    bus = pkg.testing.fault_injection.FakePodBus(4)
    bus.step([[{"op": 1, "w": i}] for i in range(4)])
    bus.step([[{"op": 2, "w": i}, {"op": 3, "w": i}] for i in range(4)])
    logs = [w.read_logs(0) for w in bus.workers]
    assert all(other == logs[0] for other in logs[1:]) and len(logs[0]) == 12
    return logs[0]


def _merge_order(pkg):
    bus = pkg.testing.fault_injection.FakePodBus(3)
    bus.step([[{"r": 0, "p": 0, "i": 0}], [{"r": 0, "p": 1, "i": 0}], []])
    bus.step([[], [{"r": 1, "p": 1, "i": 0}, {"r": 1, "p": 1, "i": 1}], [{"r": 1, "p": 2, "i": 0}]])
    merged = bus.workers[0].read_logs(0)
    keys = [(m["r"], m["p"], m["i"]) for m in merged]
    assert keys == sorted(keys)
    return merged


def _unbalanced(pkg):
    rng = np.random.RandomState(0)
    bus = pkg.testing.fault_injection.FakePodBus(4)
    for round_no in range(6):
        bus.step([
            [{"round": round_no, "proc": p, "seq": s, "blob": "x" * int(rng.randint(1, 200))}
             for s in range(int(rng.randint(0, 5)))]
            for p in range(4)
        ])
    logs = [w.read_logs(0) for w in bus.workers]
    assert all(other == logs[0] for other in logs[1:])
    return logs[0]


def _failed_collective_retry(pkg):
    backend = pkg.parallel.IciJournalBackend(buffer_bytes=4096)
    attempts = {"n": 0}
    ops = [{"op": 7, "k": "v"}, {"op": 8}]

    def flaky_gather(buf):
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("link flap")
        return np.stack([buf])

    backend._allgather = flaky_gather
    backend._pending.extend(ops)
    with pytest.raises(RuntimeError, match="link flap"):
        backend.exchange()
    assert backend.read_logs(0) == [] and backend._pending == ops  # nothing merged, nothing lost
    backend.exchange()
    assert backend._pending == [] and backend._round == 1
    return backend.read_logs(0)


def _overflow(pkg):
    backend = pkg.parallel.IciJournalBackend(buffer_bytes=256)
    backend._pending.extend([{"blob": "y" * 500}])
    with pytest.raises(ValueError, match="overflow"):
        backend.exchange()
    return backend._pending


def _two_studies(pkg):
    bus = pkg.testing.fault_injection.FakePodBus(2)
    stores = [pkg.storages.journal.JournalStorage(w) for w in bus.workers]
    MIN = pkg.study.StudyDirection.MINIMIZE
    COMPLETE = pkg.trial.TrialState.COMPLETE
    sid0, _ = bus.lockstep(
        lambda: stores[0].create_new_study([MIN], study_name="pod-study"), lambda: bus.workers[1].exchange()
    )
    sid1 = stores[1].get_study_id_from_name("pod-study")
    assert sid1 == sid0
    t0, _ = bus.lockstep(lambda: stores[0].create_new_trial(sid0), lambda: bus.workers[1].exchange())
    _, t1 = bus.lockstep(lambda: bus.workers[0].exchange(), lambda: stores[1].create_new_trial(sid1))
    bus.lockstep(lambda: stores[0].set_trial_state_values(t0, COMPLETE, [1.0]), lambda: bus.workers[1].exchange())
    bus.lockstep(lambda: bus.workers[0].exchange(), lambda: stores[1].set_trial_state_values(t1, COMPLETE, [2.0]))
    assert stores[0].get_n_trials(sid0) == stores[1].get_n_trials(sid1) == 2
    assert sorted(t.value for t in stores[0].get_all_trials(sid0)) == [1.0, 2.0]
    assert sorted(t.value for t in stores[1].get_all_trials(sid1)) == [1.0, 2.0]
    assert bus.workers[0].read_logs(0) == bus.workers[1].read_logs(0)
    return _masked(bus.workers[0].read_logs(0))


_SCENARIOS = {
    "identical_log": _identical_log,
    "merge_order": _merge_order,
    "unbalanced_payloads": _unbalanced,
    "failed_collective_retry": _failed_collective_retry,
    "overflow_before_collective": _overflow,
    "two_studies_one_bus": _two_studies,
}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_fakepod_scenarios_merge_as_the_references(scenario):
    ref, port = (_SCENARIOS[scenario](pkg) for pkg in PKGS)
    assert port == ref


@pytest.fixture(scope="module")
def journal_ranks(tmp_path_factory):
    return workers.spawn_ranks("journal", 2, tmp_path_factory.mktemp("journal"))


def test_a_real_two_rank_exchange_derives_one_merged_log(journal_ranks):
    merged = [workers.result(journal_ranks, "journal_exchange", r)["merged"] for r in range(2)]
    assert merged[0] == merged[1]
    assert [(op["proc"], op["seq"]) for op in merged[0]] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert workers.result(journal_ranks, "journal_exchange", 0)["round"] == 2


def test_one_rank_exchanges_without_a_collective():
    backend = optuna_tpu_torch.parallel.IciJournalBackend()
    assert backend._allgather(backend._pack([{"op": 1}])) is None
    backend.append_logs([{"op": 1}])
    assert backend.read_logs(0) == [{"op": 1}] and backend._round == 1
