"""Importable BaseStorage behavioral suite (port of
``optuna_tpu/testing/pytest_storages.py``).

Parity target: ``optuna/testing/pytest_storages.py`` — a shipped library of
backend-agnostic storage checks that any ``BaseStorage`` author (including
third-party backends) can run against their implementation:

    from optuna_tpu_torch.testing.pytest_storages import StorageTestCase

    class TestMyStorage(StorageTestCase):
        @pytest.fixture
        def storage(self):
            yield MyStorage(...)

Covers study CRUD and naming, directions, attrs, trial lifecycle and
immutability rules, param/distribution round-trips, the claim CAS,
intermediate values, filtered reads, best-trial semantics, convenience
getters, incremental partial reads, cross-thread number uniqueness, the
checkpoint ring and the op-token attrs. The in-repo run lives in ``tests/test_torch_storages.py``.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from optuna_tpu_torch.distributions import (
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from optuna_tpu_torch.exceptions import DuplicatedStudyError
from optuna_tpu_torch.storages import BaseStorage
from optuna_tpu_torch.study import StudyDirection
from optuna_tpu_torch.trial import FrozenTrial, TrialState

MINIMIZE = [StudyDirection.MINIMIZE]
BOTH = [StudyDirection.MINIMIZE, StudyDirection.MAXIMIZE]


class StorageTestCase:
    """Subclass and provide a ``storage`` fixture yielding a fresh, empty
    ``BaseStorage`` per test."""

    @pytest.fixture
    def storage(self) -> BaseStorage:
        raise NotImplementedError("provide a `storage` fixture")

    # --------------------------------------------------------------- studies

    def test_study_create_and_name_round_trip(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE, study_name="alpha")
        assert storage.get_study_id_from_name("alpha") == sid
        assert storage.get_study_name_from_id(sid) == "alpha"
        # Unnamed studies get a generated unique name.
        sid2 = storage.create_new_study(MINIMIZE)
        name2 = storage.get_study_name_from_id(sid2)
        assert name2 and name2 != "alpha"
        assert storage.get_study_id_from_name(name2) == sid2

    def test_duplicate_study_name_raises(self, storage: BaseStorage) -> None:
        storage.create_new_study(MINIMIZE, study_name="dup")
        with pytest.raises(DuplicatedStudyError):
            storage.create_new_study(MINIMIZE, study_name="dup")

    def test_missing_study_lookup_raises(self, storage: BaseStorage) -> None:
        with pytest.raises(KeyError):
            storage.get_study_id_from_name("never-created")
        with pytest.raises(KeyError):
            storage.get_study_name_from_id(10_000_019)

    def test_delete_study_removes_trials_and_name(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE, study_name="doomed")
        tid = storage.create_new_trial(sid)
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [1.0])
        storage.delete_study(sid)
        with pytest.raises(KeyError):
            storage.get_study_id_from_name("doomed")
        # The name becomes available again.
        sid2 = storage.create_new_study(MINIMIZE, study_name="doomed")
        assert storage.get_all_trials(sid2) == []

    def test_study_directions_persist(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(BOTH)
        assert storage.get_study_directions(sid) == BOTH
        sid1 = storage.create_new_study(MINIMIZE)
        assert storage.get_study_directions(sid1) == MINIMIZE

    def test_study_attrs(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        storage.set_study_user_attr(sid, "owner", "me")
        storage.set_study_user_attr(sid, "tags", ["a", "b"])
        storage.set_study_system_attr(sid, "internal", {"k": 1})
        assert storage.get_study_user_attrs(sid) == {"owner": "me", "tags": ["a", "b"]}
        assert storage.get_study_system_attrs(sid) == {"internal": {"k": 1}}
        # Overwrite.
        storage.set_study_user_attr(sid, "owner", "you")
        assert storage.get_study_user_attrs(sid)["owner"] == "you"

    def test_get_all_studies_summaries(self, storage: BaseStorage) -> None:
        ids = [storage.create_new_study(MINIMIZE, study_name=f"s{i}") for i in range(3)]
        studies = storage.get_all_studies()
        assert {s._study_id for s in studies} >= set(ids)
        names = {s.study_name for s in studies}
        assert {"s0", "s1", "s2"} <= names

    # ---------------------------------------------------------------- trials

    def test_trial_numbers_are_dense_and_ordered(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        tids = [storage.create_new_trial(sid) for _ in range(5)]
        numbers = [storage.get_trial_number_from_id(t) for t in tids]
        assert numbers == [0, 1, 2, 3, 4]
        for num, tid in zip(numbers, tids):
            assert storage.get_trial_id_from_study_id_trial_number(sid, num) == tid
        # Numbers are per-study.
        sid2 = storage.create_new_study(MINIMIZE)
        assert storage.get_trial_number_from_id(storage.create_new_trial(sid2)) == 0

    def test_create_trial_from_template(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        template = FrozenTrial(
            number=-1,
            state=TrialState.COMPLETE,
            value=0.25,
            datetime_start=None,
            datetime_complete=None,
            params={"x": 2.0},
            distributions={"x": FloatDistribution(0.0, 4.0)},
            user_attrs={"note": "seeded"},
            system_attrs={},
            intermediate_values={0: 1.0},
            trial_id=-1,
        )
        tid = storage.create_new_trial(sid, template_trial=template)
        got = storage.get_trial(tid)
        assert got.state == TrialState.COMPLETE
        assert got.value == 0.25
        assert got.params == {"x": 2.0}
        assert got.user_attrs == {"note": "seeded"}
        assert got.intermediate_values == {0: 1.0}

    def test_trial_param_set_and_read_back(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        fdist = FloatDistribution(0.0, 10.0)
        idist = IntDistribution(0, 8)
        cdist = CategoricalDistribution(("a", "b"))
        storage.set_trial_param(tid, "f", 3.5, fdist)
        storage.set_trial_param(tid, "i", 4.0, idist)
        storage.set_trial_param(tid, "c", 1.0, cdist)
        assert storage.get_trial_param(tid, "f") == 3.5
        assert storage.get_trial_param(tid, "i") == 4.0
        assert storage.get_trial_param(tid, "c") == 1.0
        frozen = storage.get_trial(tid)
        assert frozen.params == {"f": 3.5, "i": 4, "c": "b"}
        assert frozen.distributions["f"] == fdist
        assert storage.get_trial_params(tid) == frozen.params

    def test_completed_trial_is_immutable(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [1.0])
        with pytest.raises(RuntimeError):
            storage.set_trial_param(tid, "x", 0.5, FloatDistribution(0, 1))
        with pytest.raises(RuntimeError):
            storage.set_trial_state_values(tid, TrialState.COMPLETE, [2.0])
        with pytest.raises(RuntimeError):
            storage.set_trial_intermediate_value(tid, 0, 1.0)
        with pytest.raises(RuntimeError):
            storage.set_trial_user_attr(tid, "k", "v")
        with pytest.raises(RuntimeError):
            storage.check_trial_is_updatable(tid, storage.get_trial(tid).state)

    def test_running_to_waiting_transition_allowed(self, storage: BaseStorage) -> None:
        """Re-parking a RUNNING trial to WAITING is permitted (the reference
        allows it; retry machinery depends on re-queueing)."""
        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        assert storage.get_trial(tid).state == TrialState.RUNNING
        assert storage.set_trial_state_values(tid, TrialState.WAITING)
        assert storage.get_trial(tid).state == TrialState.WAITING
        # ... and it can be claimed again.
        assert storage.set_trial_state_values(tid, TrialState.RUNNING)

    def test_cas_claims_single_winner(self, storage: BaseStorage) -> None:
        """set_trial_state_values RUNNING->RUNNING acts as the claim CAS:
        exactly one concurrent claimer wins a WAITING trial."""
        sid = storage.create_new_study(MINIMIZE)
        template = FrozenTrial(
            number=-1, state=TrialState.WAITING, value=None,
            datetime_start=None, datetime_complete=None, params={},
            distributions={}, user_attrs={}, system_attrs={},
            intermediate_values={}, trial_id=-1,
        )
        tid = storage.create_new_trial(sid, template_trial=template)
        wins = [storage.set_trial_state_values(tid, TrialState.RUNNING) for _ in range(3)]
        assert wins.count(True) == 1

    def test_intermediate_values_and_overwrite(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        storage.set_trial_intermediate_value(tid, 0, 10.0)
        storage.set_trial_intermediate_value(tid, 5, 5.0)
        storage.set_trial_intermediate_value(tid, 0, 9.0)  # overwrite
        got = storage.get_trial(tid).intermediate_values
        assert got == {0: 9.0, 5: 5.0}

    def test_trial_attrs_persist(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        storage.set_trial_user_attr(tid, "lr", 0.1)
        storage.set_trial_system_attr(tid, "retry_of", 3)
        got = storage.get_trial(tid)
        assert got.user_attrs == {"lr": 0.1}
        assert got.system_attrs == {"retry_of": 3}
        assert storage.get_trial_user_attrs(tid) == {"lr": 0.1}
        assert storage.get_trial_system_attrs(tid) == {"retry_of": 3}

    def test_sampler_fallback_attrs_round_trip(self, storage: BaseStorage) -> None:
        """Fallback lineage (`sampler_fallback:` attrs written by the sampler
        resilience layer mid-RUNNING) must survive the trial's whole
        lifecycle: readable while RUNNING, intact after the terminal write,
        and visible through both the single-trial and bulk read paths."""
        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        reason = "ValueError: non-finite proposal for ['x']"
        storage.set_trial_system_attr(tid, "sampler_fallback:relative", reason)
        storage.set_trial_system_attr(
            tid, "sampler_fallback:independent:y", "RuntimeError: injected"
        )
        assert storage.get_trial(tid).system_attrs["sampler_fallback:relative"] == reason
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [1.0])
        got = storage.get_all_trials(sid)[0].system_attrs
        assert got["sampler_fallback:relative"] == reason
        assert got["sampler_fallback:independent:y"] == "RuntimeError: injected"

    def test_get_all_trials_state_filter_and_copy(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        for k in range(6):
            tid = storage.create_new_trial(sid)
            if k % 2 == 0:
                storage.set_trial_state_values(tid, TrialState.COMPLETE, [float(k)])
        complete = storage.get_all_trials(sid, states=(TrialState.COMPLETE,))
        running = storage.get_all_trials(sid, states=(TrialState.RUNNING,))
        assert len(complete) == 3 and len(running) == 3
        assert storage.get_n_trials(sid) == 6
        assert storage.get_n_trials(sid, state=TrialState.COMPLETE) == 3
        # deepcopy=True must hand back an isolated object.
        t0 = storage.get_all_trials(sid, deepcopy=True)[0]
        t0.user_attrs["mutate"] = 1
        assert "mutate" not in storage.get_all_trials(sid, deepcopy=True)[0].user_attrs

    def test_read_trials_partial_watermark(self, storage: BaseStorage) -> None:
        """The incremental-read contract behind _CachedStorage: ids above the
        watermark plus explicitly listed ids, nothing else."""
        sid = storage.create_new_study(MINIMIZE)
        tids = [storage.create_new_trial(sid) for _ in range(4)]
        storage.set_trial_state_values(tids[0], TrialState.COMPLETE, [0.0])
        got = storage._read_trials_partial(sid, tids[1], {tids[0]})
        got_ids = {t._trial_id for t in got}
        assert got_ids == {tids[0], tids[2], tids[3]}

    def test_best_trial_semantics(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        with pytest.raises(ValueError):
            storage.get_best_trial(sid)
        values = [3.0, 1.0, 2.0]
        for v in values:
            tid = storage.create_new_trial(sid)
            storage.set_trial_state_values(tid, TrialState.COMPLETE, [v])
        assert storage.get_best_trial(sid).value == 1.0
        # Maximize study picks the max.
        sid2 = storage.create_new_study([StudyDirection.MAXIMIZE])
        for v in values:
            tid = storage.create_new_trial(sid2)
            storage.set_trial_state_values(tid, TrialState.COMPLETE, [v])
        assert storage.get_best_trial(sid2).value == 3.0

    def test_datetime_fields_progress(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        running = storage.get_trial(tid)
        assert running.datetime_start is not None
        assert running.datetime_complete is None
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [0.0])
        done = storage.get_trial(tid)
        assert done.datetime_complete is not None
        assert done.datetime_complete >= done.datetime_start

    def test_multi_objective_values_round_trip(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(BOTH)
        tid = storage.create_new_trial(sid)
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [1.5, -2.5])
        assert storage.get_trial(tid).values == [1.5, -2.5]

    def test_nan_and_inf_values_survive(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [float("inf")])
        assert storage.get_trial(tid).value == float("inf")
        tid2 = storage.create_new_trial(sid)
        storage.set_trial_intermediate_value(tid2, 0, float("nan"))
        assert np.isnan(storage.get_trial(tid2).intermediate_values[0])

    def test_cross_thread_trial_numbers_unique(self, storage: BaseStorage) -> None:
        sid = storage.create_new_study(MINIMIZE)
        numbers: list[int] = []
        lock = threading.Lock()

        def worker() -> None:
            for _ in range(10):
                tid = storage.create_new_trial(sid)
                n = storage.get_trial_number_from_id(tid)
                with lock:
                    numbers.append(n)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(numbers) == list(range(40))

    def test_unknown_trial_id_raises(self, storage: BaseStorage) -> None:
        storage.create_new_study(MINIMIZE)
        with pytest.raises(KeyError):
            storage.get_trial(987654321)

    # -------------------------------------------- checkpoint attr namespace
    # The preemption checkpoints (``checkpoint.py``) persist through the
    # plain study-system-attr surface, so the ``ckpt:`` namespace is part of
    # the storage contract: every backend must round-trip the framed blobs,
    # keep the two-slot ring bounded, and never clobber neighboring system
    # attrs, including under injected transient faults.

    def test_checkpoint_round_trip(self, storage: BaseStorage) -> None:
        from optuna_tpu_torch import checkpoint as ckpt

        sid = storage.create_new_study(MINIMIZE)
        state = {"told": 3, "x": [1.0, 2.0], "names": ("a", "b")}
        ckpt.write_checkpoint(storage, sid, "scan", state, n_told=3, seq=0)
        rec = ckpt.load_checkpoint(storage, sid, "scan")
        assert rec is not None
        assert (rec.kind, rec.seq, rec.n_told) == ("scan", 0, 3)
        assert rec.state["x"] == [1.0, 2.0]
        assert rec.state["names"] == ("a", "b")
        # Kinds are independent namespaces.
        assert ckpt.load_checkpoint(storage, sid, "hub") is None

    def test_checkpoint_newest_slot_wins_ring_bounded(self, storage: BaseStorage) -> None:
        from optuna_tpu_torch import checkpoint as ckpt

        sid = storage.create_new_study(MINIMIZE)
        for seq in range(5):
            ckpt.write_checkpoint(storage, sid, "scan", {"echo": seq}, n_told=seq, seq=seq)
        rec = ckpt.load_checkpoint(storage, sid, "scan")
        assert rec is not None and rec.seq == 4 and rec.state["echo"] == 4
        keys = [k for k in storage.get_study_system_attrs(sid) if k.startswith(ckpt.CKPT_ATTR_PREFIX)]
        # Bounded ring: five writes leave exactly RING_SLOTS keys, not five.
        assert len(keys) == ckpt.RING_SLOTS
        assert ckpt.max_slot_seq(storage, sid, "scan") == 4

    def test_checkpoint_corrupt_newest_falls_back_to_older(self, storage: BaseStorage) -> None:
        from optuna_tpu_torch import checkpoint as ckpt

        sid = storage.create_new_study(MINIMIZE)
        ckpt.write_checkpoint(storage, sid, "scan", {"n": 6}, n_told=6, seq=6)
        ckpt.write_checkpoint(storage, sid, "scan", {"n": 7}, n_told=7, seq=7)
        slot = 7 % ckpt.RING_SLOTS
        storage.set_study_system_attr(sid, f"{ckpt.CKPT_ATTR_PREFIX}scan:{slot}", "!not-base64!")
        rec = ckpt.load_checkpoint(storage, sid, "scan")
        assert rec is not None and rec.seq == 6 and rec.state["n"] == 6

    def test_checkpoint_future_watermark_rejected(self, storage: BaseStorage) -> None:
        from optuna_tpu_torch import checkpoint as ckpt

        sid = storage.create_new_study(MINIMIZE)
        ckpt.write_checkpoint(storage, sid, "scan", {}, n_told=10, seq=0)
        # A checkpoint claiming MORE synced tells than the storage holds is
        # from a future the storage never saw: refused, not trusted.
        assert ckpt.load_checkpoint(storage, sid, "scan", synced_told=4) is None
        assert ckpt.load_checkpoint(storage, sid, "scan", synced_told=10) is not None

    def test_checkpoint_op_token_round_trip(self, storage: BaseStorage) -> None:
        from optuna_tpu_torch import checkpoint as ckpt

        sid = storage.create_new_study(MINIMIZE)
        tid = storage.create_new_trial(sid)
        token = ckpt.op_token(2, 5, 1)
        storage.set_trial_system_attr(tid, ckpt.OP_TOKEN_ATTR, token)
        storage.set_trial_state_values(tid, TrialState.COMPLETE, [0.5])
        ops = ckpt.synced_ops(storage.get_all_trials(sid, deepcopy=False))
        assert token in ops.told
        assert ops.max_run_id == 2
        assert ckpt.parse_op_token(token) == (2, 5, 1)

    # ------------------------------------------------- lease attr namespace
    # The fleet's study-ownership leases (storages/_grpc/fleet.py) persist
    # through the same study-system-attr surface, so the `lease:` namespace
    # is part of the storage contract: every backend must round-trip the
    # epoch-numbered record, keep the epoch monotonic across takeovers, and
    # enforce stale-epoch rejection through LeaseFencedStorage — including
    # under injected transient faults (the under-faults matrix reruns these
    # rows through FaultInjectorStorage).

    def test_lease_record_round_trip_and_epoch_monotonic(
        self, storage: BaseStorage
    ) -> None:
        from optuna_tpu_torch.storages._grpc import fleet

        sid = storage.create_new_study(MINIMIZE)
        owner = fleet.StudyLeases(storage, "hub-a", check_ttl_s=0.0)
        assert owner.acquire(sid) == 1
        rec = fleet.read_lease(storage, sid)
        assert rec is not None
        assert (rec["owner"], rec["epoch"]) == ("hub-a", 1)
        assert rec["ttl_s"] == owner.ttl_s
        assert rec["history"][-1]["owner"] == "hub-a"
        successor = fleet.StudyLeases(storage, "hub-b", check_ttl_s=0.0)
        assert successor.acquire(sid, takeover=True) == 2
        rec = fleet.read_lease(storage, sid)
        assert (rec["owner"], rec["epoch"]) == ("hub-b", 2)
        assert [h["epoch"] for h in rec["history"]] == [1, 2]
        # Failback: the original owner reclaims with a fresh epoch — the
        # epoch never reuses a value, so zombie writes stay fenceable.
        assert owner.acquire(sid, takeover=True) == 3
        assert fleet.read_lease(storage, sid)["epoch"] == 3

    def test_lease_stale_epoch_write_rejected(self, storage: BaseStorage) -> None:
        from optuna_tpu_torch import checkpoint as ckpt
        from optuna_tpu_torch.exceptions import StaleLeaseError
        from optuna_tpu_torch.storages._grpc import fleet

        sid = storage.create_new_study(MINIMIZE)
        zombie_leases = fleet.StudyLeases(storage, "hub-a", check_ttl_s=0.0)
        demotions: list[int] = []
        fenced = fleet.LeaseFencedStorage(
            storage,
            zombie_leases,
            on_fenced=lambda study_id, err: demotions.append(study_id),
        )
        assert zombie_leases.acquire(sid) == 1
        key = f"{ckpt.CKPT_ATTR_PREFIX}hub:0"
        fenced.set_study_system_attr(sid, key, "owned-write")
        successor = fleet.StudyLeases(storage, "hub-b", check_ttl_s=0.0)
        assert successor.acquire(sid, takeover=True) == 2
        with pytest.raises(StaleLeaseError):
            fenced.set_study_system_attr(sid, key, "zombie-write")
        # The rejected write never reached the backing storage, and the
        # demotion callback fired for exactly this study.
        assert storage.get_study_system_attrs(sid)[key] == "owned-write"
        assert demotions == [sid]
        # Non-serve-state attrs stay unfenced (single-writer diagnostics).
        fenced.set_study_system_attr(sid, "unrelated", "passes")
        assert storage.get_study_system_attrs(sid)["unrelated"] == "passes"

    def test_retry_clone_fixed_params_survive_checkpointed_study(self, storage: BaseStorage) -> None:
        from optuna_tpu_torch import checkpoint as ckpt

        sid = storage.create_new_study(MINIMIZE)
        dist = FloatDistribution(0.0, 1.0)
        tid = storage.create_new_trial(sid)
        storage.set_trial_param(tid, "x", 0.25, dist)
        storage.set_trial_state_values(tid, TrialState.FAIL)
        clone = FrozenTrial(
            number=-1,
            state=TrialState.WAITING,
            value=None,
            datetime_start=None,
            datetime_complete=None,
            params={"x": 0.25},
            distributions={"x": dist},
            user_attrs={},
            system_attrs={"failed_trial": 0, "retry_history": [0], "fixed_params": {"x": 0.25}},
            intermediate_values={},
            trial_id=-1,
        )
        clone_id = storage.create_new_trial(sid, template_trial=clone)
        # A mid-study checkpoint lands in the same study attr table; the
        # retry lineage must survive beside it, unclobbered, at resume.
        ckpt.write_checkpoint(storage, sid, "scan", {"told": 1}, n_told=1, seq=0)
        got = storage.get_trial(clone_id)
        assert got.system_attrs["fixed_params"] == {"x": 0.25}
        assert got.system_attrs["retry_history"] == [0]
        assert got.system_attrs["failed_trial"] == 0
        rec = ckpt.load_checkpoint(storage, sid, "scan")
        assert rec is not None and rec.n_told == 1

    # ------------------------------------------------ end-to-end over a Study

    def test_study_end_to_end_over_storage(self, storage: BaseStorage) -> None:
        import optuna_tpu_torch
        from optuna_tpu_torch.samplers import RandomSampler

        # A host sampler: the default (TPE) samples on the card, and this
        # case checks the storage, not a sampler.
        study = optuna_tpu_torch.create_study(
            storage=storage, study_name="e2e", sampler=RandomSampler(seed=0)
        )
        study.optimize(lambda t: (t.suggest_float("x", -1, 1)) ** 2, n_trials=10)
        assert len(study.trials) == 10
        reloaded = optuna_tpu_torch.load_study(storage=storage, study_name="e2e")
        assert len(reloaded.trials) == 10
        assert reloaded.best_value == study.best_value
