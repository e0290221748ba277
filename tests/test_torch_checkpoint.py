"""The port's checkpoint ring (``optuna_tpu_torch/checkpoint.py``) and the scan
loop's resume (``optimize_scan(resume=True)``) on the CPU.

- The blob contract, ported from ``tests/test_checkpoint.py``: events
  counted, best-effort writes, schema and kind rejection, the stale
  watermark, the ``max_slot_seq`` peek, op tokens and their
  classification, the fitted-sampler hooks on ``GPSampler`` and
  ``GuardedSampler``.
- Against the reference: ``encode_checkpoint`` gives the same string in
  both packages for one state with NumPy arrays, and each package's
  ``load_checkpoint`` decodes the other's blob, a real scan carry among them.
- Resume, ported from ``tests/test_checkpoint.py:260,312`` on both engines
  (exact, and SGPR through a small ``n_exact_max``): stop then resume
  equals the uninterrupted twin trial for trial, and a resume of a finished
  study does nothing.
- The chaos acceptance, ported from ``tests/test_checkpoint_chaos.py:123,184``
  under ``checkpoint_chaos_plan()`` (96 trials, ``sync_every`` 8, a kill at
  the 44th tell): kill, resume and twin over a journal file; and the
  corrupt-ring fallback, with the doctor's ``checkpoint.stale`` finding
  (``Study.health_report``, the health reporter publishing at every sync)
  as in the reference's fallback case. Also the matrix rows the
  reference covers elsewhere: a checkpoint write that fails, and a stale
  blob.

The scan runs use ``device="cpu"`` and one torch thread.
"""

from __future__ import annotations

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch as ot
from optuna_tpu_torch import checkpoint as ckpt
from optuna_tpu_torch import health, telemetry
from optuna_tpu_torch.distributions import FloatDistribution
from optuna_tpu_torch.models.benchmarks import hartmann6_torch
from optuna_tpu_torch.parallel import VectorizedObjective, optimize_scan
from optuna_tpu_torch.samplers import RandomSampler
from optuna_tpu_torch.storages import InMemoryStorage, JournalFileBackend, JournalStorage
from optuna_tpu_torch.testing.fault_injection import (
    CHECKPOINT_CHAOS_MATRIX,
    CheckpointChaosPlan,
    FaultInjectorStorage,
    FaultPlan,
    SimulatedWorkerDeath,
    checkpoint_chaos_plan,
)
from optuna_tpu_torch.trial import TrialState
from tests._torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

for _pkg in (optuna_tpu, ot):
    _pkg.logging.set_verbosity(_pkg.logging.ERROR)

SPACE6 = {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(6)}
#: The two engines: exact chunks, and SGPR chunks from the first one on.
ENGINES = {"exact": {}, "sgpr": {"n_exact_max": 12, "n_inducing": 8}}


@pytest.fixture(autouse=True)
def _isolated_observability():
    saved_registry = telemetry.get_registry()
    saved_enabled = telemetry.enabled()
    telemetry.enable(telemetry.MetricsRegistry())
    yield
    telemetry.enable(saved_registry)
    if not saved_enabled:
        telemetry.disable()


def _counters() -> dict:
    return telemetry.get_registry().snapshot()["counters"]


def _study_sid():
    storage = InMemoryStorage()
    sid = storage.create_new_study([ot.study.StudyDirection.MINIMIZE])
    return storage, sid


def _objective():
    return VectorizedObjective(fn=hartmann6_torch, search_space=dict(SPACE6))


def _create(storage=None, name=None):
    # The scan loop bypasses the sampler; the port's default one needs a card.
    return ot.create_study(storage=storage, study_name=name, sampler=RandomSampler(seed=0))


def _load(storage, name):
    return ot.load_study(study_name=name, storage=storage, sampler=RandomSampler(seed=0))


def _complete_params(study):
    return [t.params for t in study.trials if t.state == TrialState.COMPLETE]


# ----------------------------------------------------------- blob contract


def test_write_then_load_counts_events():
    storage, sid = _study_sid()
    assert ckpt.write_checkpoint(storage, sid, "scan", {"a": 1}, n_told=4, seq=0)
    rec = ckpt.load_checkpoint(storage, sid, "scan")
    assert rec == ckpt.CheckpointRecord(kind="scan", seq=0, n_told=4, state={"a": 1})
    counters = _counters()
    assert counters["checkpoint.write"] == 1
    assert counters["checkpoint.restore"] == 1


def test_write_is_best_effort_on_storage_failure():
    class _Broken:
        def set_study_system_attr(self, *a, **k):
            raise RuntimeError("disk on fire")

    assert ckpt.write_checkpoint(_Broken(), 0, "scan", {}, n_told=0, seq=0) is False
    assert _counters()["checkpoint.write_error"] == 1


def test_schema_version_mismatch_rejected(monkeypatch):
    storage, sid = _study_sid()
    storage.set_study_system_attr(sid, "ckpt:scan:0", ckpt.encode_checkpoint("scan", {}, n_told=0, seq=0))
    monkeypatch.setattr(ckpt, "CHECKPOINT_SCHEMA_VERSION", ckpt.CHECKPOINT_SCHEMA_VERSION + 1)
    assert ckpt.load_checkpoint(storage, sid, "scan") is None
    assert _counters()["checkpoint.rejected"] == 1


def test_kind_mismatch_and_nonstring_rejected():
    storage, sid = _study_sid()
    storage.set_study_system_attr(sid, "ckpt:scan:0", ckpt.encode_checkpoint("hub", {}, n_told=0, seq=0))
    storage.set_study_system_attr(sid, "ckpt:scan:1", 12345)
    assert ckpt.load_checkpoint(storage, sid, "scan") is None
    assert _counters()["checkpoint.rejected"] == 2


def test_stale_watermark_counted_and_skipped():
    storage, sid = _study_sid()
    ckpt.write_checkpoint(storage, sid, "scan", {}, n_told=10, seq=0)
    assert ckpt.load_checkpoint(storage, sid, "scan", synced_told=40, max_lag=16) is None
    assert _counters()["checkpoint.stale"] == 1
    assert ckpt.load_checkpoint(storage, sid, "scan", synced_told=20, max_lag=16) is not None


def test_max_slot_seq_survives_corrupt_newest_without_counting():
    storage, sid = _study_sid()
    assert ckpt.max_slot_seq(storage, sid, "scan") == -1
    ckpt.write_checkpoint(storage, sid, "scan", {}, n_told=0, seq=4)
    ckpt.write_checkpoint(storage, sid, "scan", {}, n_told=0, seq=5)
    storage.set_study_system_attr(sid, "ckpt:scan:1", "@@not base64@@")
    writes = _counters().get("checkpoint.write", 0)
    assert ckpt.max_slot_seq(storage, sid, "scan") == 4
    counters = _counters()
    assert counters.get("checkpoint.rejected", 0) == 0
    assert counters.get("checkpoint.restore", 0) == 0
    assert counters.get("checkpoint.write", 0) == writes


def test_op_token_round_trip_and_malformed():
    assert ckpt.parse_op_token(ckpt.op_token(3, 17, 2)) == (3, 17, 2)
    assert ckpt.parse_op_token(ckpt.op_token(0, "s", 5)) == (0, None, 5)
    for bad in (None, "", "r1:c2", "x1:c2:3", "r1:d2:3", "r1:c2:3:4", "r:c:s", 7):
        assert ckpt.parse_op_token(bad) is None


def test_synced_ops_classification():
    storage, sid = _study_sid()
    study = _load(storage, storage.get_study_name_from_id(sid))
    t_told = storage.create_new_trial(sid)
    storage.set_trial_system_attr(t_told, ckpt.OP_TOKEN_ATTR, ckpt.op_token(1, 0, 0))
    storage.set_trial_state_values(t_told, TrialState.COMPLETE, [0.5])
    t_run = storage.create_new_trial(sid)
    run_token = ckpt.op_token(1, 1, 0)
    storage.set_trial_system_attr(t_run, ckpt.OP_TOKEN_ATTR, run_token)
    t_stray = storage.create_new_trial(sid)
    t_reaped = storage.create_new_trial(sid)
    storage.set_trial_system_attr(t_reaped, ckpt.OP_TOKEN_ATTR, ckpt.op_token(0, 2, 1))
    storage.set_trial_system_attr(t_reaped, ckpt.STRANDED_ATTR, True)
    storage.set_trial_state_values(t_reaped, TrialState.FAIL)
    ops = ckpt.synced_ops(study.get_trials(deepcopy=False))
    assert ops.told == frozenset({ckpt.op_token(1, 0, 0)})
    assert ops.running == {run_token: t_run}
    assert ops.stranded == (t_stray,)
    assert ops.max_run_id == 1


def test_sampler_hooks_absent_or_failing_degrade():
    class _Plain:
        pass

    class _Angry:
        def export_fitted_state(self):
            raise RuntimeError("no")

        def restore_fitted_state(self, state):
            raise RuntimeError("no")

    assert ckpt.export_sampler_state(_Plain()) is None
    assert ckpt.restore_sampler_state(_Plain(), {"x": 1}) is False
    assert ckpt.restore_sampler_state(_Plain(), None) is False
    assert ckpt.export_sampler_state(_Angry()) is None
    assert ckpt.restore_sampler_state(_Angry(), {"x": 1}) is False


def test_gp_sampler_fitted_state_round_trip_and_guarded_delegation():
    from optuna_tpu_torch.samplers import GPSampler
    from optuna_tpu_torch.samplers._resilience import GuardedSampler

    cold = GPSampler(seed=0, device="cpu")
    assert cold.export_fitted_state() is None
    assert ckpt.restore_sampler_state(cold, None) is False
    assert cold.restore_fitted_state({}) is False
    donor = GPSampler(seed=0, device="cpu")
    donor._kernel_params_cache[("sig", 8)] = [np.ones(3), np.float64(2.0)]
    state = ckpt.export_sampler_state(GuardedSampler(donor))
    assert state is not None
    heir = GPSampler(seed=1, device="cpu")
    assert ckpt.restore_sampler_state(GuardedSampler(heir), state) is True
    np.testing.assert_array_equal(heir._kernel_params_cache[("sig", 8)][0], np.ones(3))
    # Live fits win over a restored state.
    heir._kernel_params_cache[("sig", 8)] = [np.zeros(3)]
    assert heir.restore_fitted_state(state) is True
    np.testing.assert_array_equal(heir._kernel_params_cache[("sig", 8)][0], np.zeros(3))


# --------------------------------------------------- against the reference


def _state_with_arrays():
    rng = np.random.RandomState(4)
    return {
        "param_names": ("x0", "x1"),
        "bucket": 64,
        "X": rng.uniform(size=(64, 2)).astype(np.float32),
        "n_dev": 40,
        "rng_state": np.random.RandomState(9).get_state(),
        "warm_raw": None,
        "nested": {"a": [1.0, float("inf")], "b": np.arange(5, dtype=np.int64)},
    }


def test_blobs_encode_byte_identically_in_both_packages():
    from optuna_tpu import checkpoint as ref_ckpt

    state = _state_with_arrays()
    for kwargs in ({"n_told": 40, "seq": 3}, {"n_told": 0, "seq": 0, "fence": 2}):
        assert ckpt.encode_checkpoint("scan", state, **kwargs) == ref_ckpt.encode_checkpoint("scan", state, **kwargs)
    assert ckpt.CHECKPOINT_SCHEMA_VERSION == ref_ckpt.CHECKPOINT_SCHEMA_VERSION
    assert ckpt.RING_SLOTS == ref_ckpt.RING_SLOTS
    assert set(ckpt.CHECKPOINT_EVENTS) == set(ref_ckpt.CHECKPOINT_EVENTS)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_loads_the_others_blob(writer):
    from optuna_tpu import checkpoint as ref_ckpt

    mods = {"reference": ref_ckpt, "port": ckpt}
    reader = mods["port" if writer == "reference" else "reference"]
    storage, sid = _study_sid()
    state = _state_with_arrays()
    assert mods[writer].write_checkpoint(storage, sid, "scan", state, n_told=40, seq=5)
    rec = reader.load_checkpoint(storage, sid, "scan", synced_told=40)
    assert (rec.kind, rec.seq, rec.n_told) == ("scan", 5, 40)
    np.testing.assert_array_equal(rec.state["X"], state["X"])
    assert rec.state["rng_state"][0] == "MT19937"
    np.testing.assert_array_equal(rec.state["rng_state"][1], state["rng_state"][1])
    assert reader.max_slot_seq(storage, sid, "scan") == 5


def test_a_scan_carry_holds_plain_types_and_loads_in_the_reference():
    from optuna_tpu import checkpoint as ref_ckpt

    study = _create()
    optimize_scan(study, _objective(), 24, sync_every=8, n_startup_trials=8, seed=1, device="cpu", **ENGINES["sgpr"])
    rec = ref_ckpt.load_checkpoint(study._storage, study._study_id, "scan")
    assert rec is not None and rec.n_told == 24
    state = rec.state
    for field in ("X", "y", "m", "warm_raw", "Z", "zy", "zm"):
        assert type(state[field]) is np.ndarray and state[field].dtype == np.float32, field
    assert state["X"].shape == (state["bucket"], 6)
    assert state["Z"].shape == (state["m_pad"], 6)
    assert all(type(state[k]) is int for k in ("bucket", "n_upper", "chunk_idx", "key_seed", "n_dev", "m_pad", "told"))
    assert state["param_names"] == tuple(SPACE6)


# --------------------------------------------- resume on the CPU (both engines)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_scan_stop_then_resume_matches_uninterrupted_twin(engine):
    kwargs = dict(sync_every=8, n_startup_trials=8, seed=5, device="cpu", **ENGINES[engine])
    twin = _create()
    optimize_scan(twin, _objective(), 32, **kwargs)

    stopped = [0]

    def _stop_after_20(study, _trial):
        stopped[0] += 1
        if stopped[0] == 20:
            study.stop()

    study = _create()
    optimize_scan(study, _objective(), 32, callbacks=[_stop_after_20], **kwargs)
    assert len(study.trials) < 32
    optimize_scan(study, _objective(), 32, resume=True, **kwargs)
    # Study.stop() mid-chunk fails the chunk's untold slots; the resume
    # re-tells exactly those, so the COMPLETE trials equal the twin's.
    complete = [t for t in study.trials if t.state == TrialState.COMPLETE]
    assert len(complete) == 32
    assert not any(t.state == TrialState.RUNNING for t in study.trials)
    assert study.best_value == twin.best_value
    assert sorted(tuple(sorted(p.items())) for p in _complete_params(study)) == sorted(
        tuple(sorted(p.items())) for p in _complete_params(twin)
    )
    counters = _counters()
    assert counters["checkpoint.restore"] == 1
    assert counters.get("checkpoint.fallback", 0) == 0


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_resume_of_finished_study_is_a_noop(engine):
    kwargs = dict(sync_every=8, n_startup_trials=8, seed=3, device="cpu", **ENGINES[engine])
    study = _create()
    optimize_scan(study, _objective(), 16, **kwargs)
    before = [(t.number, t.state) for t in study.trials]
    optimize_scan(study, _objective(), 16, resume=True, **kwargs)
    assert [(t.number, t.state) for t in study.trials] == before
    assert _counters()["checkpoint.restore"] == 1


# ------------------------------------------------------------ preemption chaos


def _optimize(study, plan: CheckpointChaosPlan, *, resume: bool = False) -> None:
    optimize_scan(
        study, _objective(), n_trials=plan.n_trials, sync_every=plan.sync_every,
        n_startup_trials=plan.n_startup_trials, seed=plan.seed, resume=resume, device="cpu",
    )


def _op_tokens(trials):
    return [t.system_attrs[ckpt.OP_TOKEN_ATTR] for t in trials if ckpt.OP_TOKEN_ATTR in t.system_attrs]


def _killed(backend, plan, name):
    injector = FaultInjectorStorage(
        backend, FaultPlan(kill_schedule={"set_trial_state_values": (plan.preempt_after_tells,)})
    )
    study = _create(injector, name)
    with pytest.raises(SimulatedWorkerDeath):
        _optimize(study, plan)
    assert injector.kills_injected == 1


def test_checkpoint_chaos_matrix_covers_every_loop_event():
    # The loops' events and the serve tier's hub re-home (``warm_load``,
    # tests/test_torch_fleet.py).
    assert set(CHECKPOINT_CHAOS_MATRIX) == set(ckpt.CHECKPOINT_EVENTS)


def test_plan_preempts_mid_chunk():
    plan = checkpoint_chaos_plan()
    assert plan.preempt_after_tells > plan.n_startup_trials
    assert (plan.preempt_after_tells - plan.n_startup_trials) % plan.sync_every != 0
    assert plan.preempt_after_tells < plan.n_trials
    assert plan.preempt_chunk == 4


def test_kill_mid_chunk_resume_reaches_twin(tmp_path):
    """Kill mid-chunk-sync over a durable journal, resume from a fresh
    storage object, and the study equals the run that never died: the
    exact budget, nothing RUNNING, every tell once, the twin's trials."""
    plan = checkpoint_chaos_plan()
    path = str(tmp_path / "chaos.log")
    _killed(JournalStorage(JournalFileBackend(path)), plan, "preempt")

    dead = _load(JournalStorage(JournalFileBackend(path)), "preempt")
    told_before = {
        t.system_attrs[ckpt.OP_TOKEN_ATTR]
        for t in dead.trials
        if t.state.is_finished() and ckpt.OP_TOKEN_ATTR in t.system_attrs
    }
    assert len(told_before) == plan.preempt_after_tells
    running = [t for t in dead.trials if t.state == TrialState.RUNNING]
    # One token-stamped stray (adopted) and the chunk's tokenless rest (reaped).
    assert sum(ckpt.OP_TOKEN_ATTR in t.system_attrs for t in running) == 1
    assert len(running) == plan.sync_every - (plan.preempt_after_tells - plan.n_startup_trials) % plan.sync_every

    resumed = _load(JournalStorage(JournalFileBackend(path)), "preempt")
    _optimize(resumed, plan, resume=True)
    trials = resumed.trials
    complete = [t for t in trials if t.state == TrialState.COMPLETE]
    assert len(complete) == plan.n_trials
    assert sum(1 for t in trials if t.state == TrialState.RUNNING) == 0
    tokens = _op_tokens(trials)
    assert len(tokens) == len(set(tokens))
    assert told_before <= set(tokens)
    strays = [t for t in trials if t.system_attrs.get(ckpt.STRANDED_ATTR)]
    assert len(strays) == len(running) - 1
    assert all(t.state == TrialState.FAIL for t in strays)

    twin = _create()
    _optimize(twin, plan)
    assert resumed.best_value == twin.best_value
    # Trial for trial in tell order, values too, not just as sets.
    assert [(t.params, t.values) for t in complete] == [
        (t.params, t.values) for t in twin.trials if t.state == TrialState.COMPLETE
    ]
    counters = _counters()
    assert counters.get("checkpoint.restore", 0) == 1
    assert counters.get("checkpoint.fallback", 0) == 0
    assert counters.get("checkpoint.write", 0) >= 2


def test_corrupt_ring_falls_back_and_recomputes():
    """Garble every ``ckpt:`` ring slot before the resume: each blob is
    rejected and counted, and the study still completes the exact remaining
    budget via the recompute-from-COMPLETE-history fallback."""
    plan = checkpoint_chaos_plan()
    backend = InMemoryStorage()
    _killed(backend, plan, "corrupt")
    sid = backend.get_study_id_from_name("corrupt")
    for slot in plan.corrupt_slots:
        backend.set_study_system_attr(sid, f"{ckpt.CKPT_ATTR_PREFIX}scan:{slot}", "@@torn mid-write@@")

    resumed = _load(backend, "corrupt")
    interval = health._interval_s
    health.enable(interval_s=0.0)
    try:
        _optimize(resumed, plan, resume=True)
    finally:
        health.disable()
        health._interval_s = interval  # enable's interval outlives disable
    trials = resumed.trials
    assert len([t for t in trials if t.state == TrialState.COMPLETE]) == plan.n_trials
    assert sum(1 for t in trials if t.state == TrialState.RUNNING) == 0
    tokens = _op_tokens(trials)
    assert len(tokens) == len(set(tokens))
    counters = _counters()
    assert counters.get("checkpoint.rejected", 0) >= len(plan.corrupt_slots)
    assert counters.get("checkpoint.fallback", 0) == 1
    assert counters.get("checkpoint.restore", 0) == 0
    findings = {f["check"]: f for f in resumed.health_report()["findings"]}
    assert findings["checkpoint.stale"]["severity"] == "WARNING"
    assert findings["checkpoint.stale"]["evidence"]["fallbacks"] == 1


def test_stale_blob_is_skipped_and_the_resume_recomputes():
    study = _create()
    kwargs = dict(sync_every=8, n_startup_trials=8, seed=2, device="cpu")
    optimize_scan(study, _objective(), 24, **kwargs)
    # A valid blob whose watermark trails the 24 synced tells by more than
    # two write intervals (2 * 8).
    for slot in range(ckpt.RING_SLOTS):
        study._storage.set_study_system_attr(study._study_id, f"{ckpt.CKPT_ATTR_PREFIX}scan:{slot}", "")
    ckpt.write_checkpoint(study._storage, study._study_id, "scan", {"told": 0}, n_told=0, seq=99)
    optimize_scan(study, _objective(), 32, resume=True, **kwargs)
    assert len([t for t in study.trials if t.state == TrialState.COMPLETE]) == 32
    counters = _counters()
    assert counters["checkpoint.stale"] == 1
    assert counters["checkpoint.fallback"] == 1


def test_failed_checkpoint_write_is_counted_and_the_loop_continues():
    storage = FaultInjectorStorage(
        InMemoryStorage(), FaultPlan(schedule={"set_study_system_attr": (1,)})
    )
    study = _create(storage)
    optimize_scan(study, _objective(), 24, sync_every=8, n_startup_trials=8, seed=2, device="cpu")
    assert len([t for t in study.trials if t.state == TrialState.COMPLETE]) == 24
    counters = _counters()
    assert counters["checkpoint.write_error"] == 1
    assert counters["checkpoint.write"] >= 2
