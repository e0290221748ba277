"""The port's device-resident scan loop (``optuna_tpu_torch/parallel/
scan_loop.py``) against its own contract, on the CPU (``device="cpu"``),
d = 6 Hartmann-6, small n.

Ported from ``tests/test_scan_loop.py`` with their assertions: the storage
contract (in memory), the mixed-space decode, the fixed-seed twin, the
start from COMPLETE history, ``Study.optimize_scan``, ``Study.stop()`` from
a callback, validation, nested invocation, NaN quarantine, huge and ±inf
history, a new device space per candidate pool, the fault-free twin, zero
refactorizations after warm-up, the recorded phases, the disabled
telemetry's zero allocations (without the flight recorder) and a disabled
run. From ``tests/test_gp_sparse.py``: NaN never enters the inducing set,
the sparse stats report the regime, the sparse steady state has zero full
refits, the storage contract through the sparse switch. New here:
``resume=True`` on a study without a checkpoint falls back and runs,
``device=None`` raises with no GPU, every synced trial carries its op
token. The RDB and journal storage contracts (``:78``, ``:95``) run here
too, over sqlite and a journal file.

Not ported, and why:

* the compile-count bound (``:378``): nothing is compiled here;
* the per-trial race (``:480``): a wall-clock comparison, slow-marked in
  the reference, and meaningless on a CPU runner.
"""

from __future__ import annotations

import gc
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import optuna_tpu_torch as ot
from optuna_tpu_torch import checkpoint, device_stats, telemetry
from optuna_tpu_torch.distributions import (
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from optuna_tpu_torch.models.benchmarks import hartmann6_torch
from optuna_tpu_torch.parallel import VectorizedObjective, optimize_scan
from optuna_tpu_torch.samplers import RandomSampler
from optuna_tpu_torch.trial import TrialState, create_trial
from tests._torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ot.logging.set_verbosity(ot.logging.ERROR)

SPACE6 = {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(6)}


def _study():
    # The scan loop bypasses the sampler; the port's create_study needs one.
    return ot.create_study(sampler=RandomSampler(seed=0))


def _scan(study, objective, n_trials, **kwargs):
    optimize_scan(study, objective, n_trials, device="cpu", **kwargs)


def _hartmann_objective():
    return VectorizedObjective(fn=hartmann6_torch, search_space=dict(SPACE6))


def _poison_objective(threshold: float = 0.5):
    """NaN whenever x0 < threshold: a poison region, so quarantines recur."""

    def fn(params):
        vals = hartmann6_torch(params)
        return torch.where(params["x0"] < threshold, torch.full_like(vals, float("nan")), vals)

    return VectorizedObjective(fn=fn, search_space=dict(SPACE6))


@pytest.fixture(autouse=True)
def _telemetry_off():
    telemetry.disable()
    yield
    telemetry.disable()


def _record():
    telemetry.enable(telemetry.get_registry())
    telemetry.reset()


def _assert_per_trial_path_state(study, n_trials, space):
    """A scan-mode study leaves storage in the per-trial path's logical
    state: every trial terminal exactly once, COMPLETE with params under its
    distributions and a finite value, FAIL with a fail_reason system attr."""
    trials = study.trials
    assert len(trials) == n_trials
    assert [t.number for t in trials] == list(range(n_trials))
    for t in trials:
        assert t.state in (TrialState.COMPLETE, TrialState.FAIL)
        assert set(t.params) == set(space)
        assert t.distributions == space
        for name, dist in space.items():
            assert dist._contains(dist.to_internal_repr(t.params[name]))
        if t.state == TrialState.COMPLETE:
            assert t.value is not None and np.isfinite(t.value)
        else:
            assert "fail_reason" in t.system_attrs


# --------------------------------------------------------------- contract


def test_scan_study_matches_per_trial_storage_contract_in_memory():
    study = _study()
    _scan(study, _hartmann_objective(), 30, sync_every=8, n_startup_trials=8, seed=0)
    _assert_per_trial_path_state(study, 30, SPACE6)
    assert study.best_value < -1.0  # the GP actually optimizes


def test_scan_study_contract_on_rdb(tmp_path):
    from optuna_tpu_torch.storages import RDBStorage

    storage = RDBStorage(f"sqlite:///{tmp_path}/scan.db")
    study = ot.create_study(storage=storage, sampler=RandomSampler(seed=0))
    _scan(study, _hartmann_objective(), 14, sync_every=6, n_startup_trials=6, seed=0)
    _assert_per_trial_path_state(study, 14, SPACE6)
    # The logical state survives a reload through the storage.
    reloaded = ot.load_study(study_name=study.study_name, storage=storage, sampler=RandomSampler(seed=0))
    _assert_per_trial_path_state(reloaded, 14, SPACE6)


def test_scan_study_contract_on_journal(tmp_path):
    from optuna_tpu_torch.storages import JournalFileBackend, JournalStorage

    storage = JournalStorage(JournalFileBackend(str(tmp_path / "scan.log")))
    study = ot.create_study(storage=storage, sampler=RandomSampler(seed=0))
    _scan(study, _hartmann_objective(), 14, sync_every=6, n_startup_trials=6, seed=0)
    _assert_per_trial_path_state(study, 14, SPACE6)
    replay = ot.load_study(
        study_name=study.study_name,
        storage=JournalStorage(JournalFileBackend(str(tmp_path / "scan.log"))),
        sampler=RandomSampler(seed=0),
    )
    _assert_per_trial_path_state(replay, 14, SPACE6)


def test_mixed_space_decodes_on_the_device_and_records_valid_params():
    space = {
        "lr": FloatDistribution(1e-3, 1.0, log=True),
        "width": IntDistribution(4, 64),
        "act": CategoricalDistribution(["relu", "tanh", "gelu"]),
    }

    def fn(params):
        # Internal reprs: lr float, width float of int value, act int32 index.
        assert params["act"].dtype == torch.int32
        return (
            (torch.log(params["lr"]) + 3.0) ** 2
            + (params["width"] - 32.0) ** 2 / 100.0
            + params["act"].to(torch.float32)
        )

    study = _study()
    _scan(study, VectorizedObjective(fn=fn, search_space=space), 20, sync_every=6, n_startup_trials=6, seed=0)
    _assert_per_trial_path_state(study, 20, space)
    for t in study.trials:
        assert isinstance(t.params["width"], int)
        assert t.params["act"] in ("relu", "tanh", "gelu")
        assert 1e-3 <= t.params["lr"] <= 1.0


def test_fixed_seed_is_bit_identical():
    bests, param_sets = [], []
    for _ in range(2):
        study = _study()
        _scan(study, _hartmann_objective(), 26, sync_every=8, n_startup_trials=8, seed=11)
        bests.append(study.best_value)
        param_sets.append([t.params for t in study.trials])
    assert bests[0] == bests[1]
    assert param_sets[0] == param_sets[1]


def test_resumes_from_existing_complete_history():
    study = _study()
    obj = _hartmann_objective()
    _scan(study, obj, 12, sync_every=6, n_startup_trials=8, seed=0)
    _scan(study, obj, 10, sync_every=5, n_startup_trials=8, seed=1)
    # The second run found >= 8 prior COMPLETE trials, so it runs no random
    # startup block: every new trial is a GP proposal.
    _assert_per_trial_path_state(study, 22, SPACE6)
    assert not any(":cs:" in t.system_attrs[checkpoint.OP_TOKEN_ATTR] for t in study.trials[12:])


def test_study_optimize_scan_method_delegates():
    study = _study()
    study.optimize_scan(_hartmann_objective(), 12, sync_every=6, n_startup_trials=6, seed=0, device="cpu")
    _assert_per_trial_path_state(study, 12, SPACE6)


def test_stop_via_callback_leaves_no_running_trials():
    stop_after = 10

    def cb(study, frozen):
        if frozen.number + 1 >= stop_after:
            study.stop()

    study = _study()
    _scan(study, _hartmann_objective(), 40, sync_every=8, n_startup_trials=8, seed=0, callbacks=[cb])
    states = Counter(t.state for t in study.trials)
    assert states.get(TrialState.RUNNING, 0) == 0
    # Never told past the stop: the chunk run when the stop fired is
    # discarded before any of its trials exist.
    assert states[TrialState.COMPLETE] <= stop_after + 8
    assert len(study.trials) < 40


def test_validation_errors():
    obj = _hartmann_objective()
    study = _study()
    with pytest.raises(ValueError, match="n_trials"):
        _scan(study, obj, 0)
    with pytest.raises(ValueError, match="sync_every"):
        _scan(study, obj, 4, sync_every=0)
    multi = ot.create_study(directions=["minimize", "minimize"])
    with pytest.raises(ValueError, match="single-objective"):
        _scan(multi, obj, 4)
    with pytest.raises(ValueError, match="non-empty"):
        _scan(study, VectorizedObjective(fn=lambda p: 0.0, search_space={}), 4)


def test_nested_invocation_raises():
    study = _study()
    seen = []

    def cb(s, frozen):
        if not seen:
            seen.append(True)
            with pytest.raises(RuntimeError, match="Nested"):
                _scan(s, _hartmann_objective(), 4, n_startup_trials=1)

    _scan(study, _hartmann_objective(), 6, sync_every=3, n_startup_trials=3, seed=0, callbacks=[cb])
    assert seen


def test_resume_is_not_ported_yet_and_raises():
    """``resume=True`` is ported now and no longer raises: on a study with no
    checkpoint it counts the fallback and runs the whole budget. (The
    resume contract itself is ``tests/test_torch_checkpoint.py``.)"""
    _record()
    study = _study()
    _scan(study, _hartmann_objective(), 4, sync_every=2, n_startup_trials=2, seed=0, resume=True)
    assert [t.state for t in study.trials] == [TrialState.COMPLETE] * 4
    assert telemetry.snapshot()["counters"]["checkpoint.fallback"] == 1


def test_default_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    study = _study()
    with pytest.raises(RuntimeError, match="no GPU"):
        optimize_scan(study, _hartmann_objective(), 4)
    assert study.trials == []


def test_every_synced_trial_carries_its_op_token():
    study = _study()
    obj = _hartmann_objective()
    _scan(study, obj, 14, sync_every=4, n_startup_trials=6, seed=0)
    tokens = [t.system_attrs[checkpoint.OP_TOKEN_ATTR] for t in study.trials]
    want = [checkpoint.op_token(0, "s", i) for i in range(6)]
    want += [checkpoint.op_token(0, c, i) for c in range(2) for i in range(4)]
    assert tokens == want
    # A second run claims the next run id (its 14 prior trials cover the
    # startup block, so both of its trials are chunk 0's).
    _scan(study, obj, 2, sync_every=2, n_startup_trials=6, seed=1)
    assert [t.system_attrs[checkpoint.OP_TOKEN_ATTR] for t in study.trials[14:]] == [
        checkpoint.op_token(1, 0, 0), checkpoint.op_token(1, 0, 1)
    ]
    assert checkpoint.synced_ops(study.trials).max_run_id == 1
    assert len(checkpoint.synced_ops(study.trials).told) == 16


# ------------------------------------------------------------------ chaos


def test_nan_slots_quarantined_and_told_fail():
    """NaN objective slots are quarantined by the isfinite verdict, told
    FAIL at the chunk sync, and never ingested by the GP fit: asserted
    through the device-stats channel and the storage's terminal states."""
    _record()
    study = _study()
    _scan(study, _poison_objective(), 32, sync_every=8, n_startup_trials=8, seed=3)
    trials = study.trials
    assert len(trials) == 32
    states = Counter(t.state for t in trials)
    assert states.get(TrialState.RUNNING, 0) == 0
    n_fail = states.get(TrialState.FAIL, 0)
    assert n_fail > 0  # the poison region was hit
    gauges = device_stats.stat_gauges()
    scan_quar = int(gauges.get("device.scan.quarantined.total", 0))
    startup_fails = sum(1 for t in trials[:8] if t.state == TrialState.FAIL)
    assert scan_quar == n_fail - startup_fails
    assert telemetry.get_registry().counter_value("executor.quarantine") == n_fail
    n_updates = int(gauges.get("device.scan.rank1_updates.total", 0))
    n_refac = int(gauges.get("device.scan.refactorizations.total", 0))
    assert n_updates + n_refac == states[TrialState.COMPLETE] - (8 - startup_fails)
    for t in trials:
        if t.state == TrialState.COMPLETE:
            assert np.isfinite(t.value)
        else:
            assert "quarantined" in t.system_attrs["fail_reason"]


def test_huge_and_inf_history_does_not_blind_the_gp():
    """A history carrying ±inf / 1e308 objectives must not overflow the
    chunk's f32 variance (sd = inf would zero every standardized target);
    the score buffer is bounded instead."""
    study = _study()
    rng = np.random.RandomState(0)
    for i in range(10):
        value = (float("inf"), 1e308, 1.0)[i % 3]
        study.add_trial(
            create_trial(
                state=TrialState.COMPLETE,
                params={k: float(v) for k, v in zip(SPACE6, rng.uniform(0, 1, 6))},
                distributions=dict(SPACE6),
                values=[value],
            )
        )
    _record()
    _scan(study, _hartmann_objective(), 16, sync_every=8, n_startup_trials=8, seed=0)
    trials = study.trials
    assert len(trials) == 26
    new = trials[10:]
    assert all(t.state == TrialState.COMPLETE for t in new)
    assert all(np.isfinite(t.value) for t in new)
    assert min(t.value for t in new) < 0.0  # still optimizing
    assert int(device_stats.stat_gauges().get("device.scan.quarantined.total", 0)) == 0


def test_second_run_with_different_candidate_pool_builds_a_new_device_space():
    obj = _hartmann_objective()
    _scan(_study(), obj, 10, sync_every=5, n_startup_trials=5, seed=0, n_preliminary_samples=128)
    _scan(_study(), obj, 10, sync_every=5, n_startup_trials=5, seed=0, n_preliminary_samples=256)
    spaces = {k[1]: v for k, v in obj._compiled_cache.items() if k[0] == "scan_devspace"}
    assert set(spaces) == {128, 256}
    assert {k: v.sobol_base.shape[0] for k, v in spaces.items()} == {128: 128, 256: 256}


def test_fault_free_twin_is_deterministic_and_containment_free():
    _record()
    study = _study()
    _scan(study, _hartmann_objective(), 24, sync_every=8, n_startup_trials=8, seed=3)
    assert telemetry.get_registry().counter_value("executor.quarantine") == 0
    assert device_stats.stat_gauges().get("device.scan.quarantined.total", 0) == 0
    assert all(t.state == TrialState.COMPLETE for t in study.trials)


# ----------------------------------------------------- incremental tells


def test_zero_full_refactorizations_after_warmup_on_well_conditioned_history():
    """On a well-conditioned history every tell takes the incremental row
    append: the refactorization counter stays at zero across the study (the
    one-per-chunk boundary factorizations are not counted)."""
    _record()
    study = _study()
    _scan(study, _hartmann_objective(), 56, sync_every=8, n_startup_trials=8, seed=1)
    gauges = device_stats.stat_gauges()
    assert int(gauges["device.scan.refactorizations.total"]) == 0
    assert int(gauges["device.scan.rank1_updates.total"]) == 48
    assert int(gauges["device.scan.chunk_fill.last"]) == 8


# ------------------------------------------------------------ observability


def test_scan_phases_recorded_on_the_shared_vocabulary():
    _record()
    study = _study()
    _scan(study, _hartmann_objective(), 24, sync_every=8, n_startup_trials=8, seed=0)
    phases = telemetry.phase_totals()
    assert phases["scan.chunk"]["count"] == 2
    assert phases["scan.sync"]["count"] == 2
    assert phases["dispatch"]["count"] == 1  # the startup evaluator
    assert "scan.chunk" in telemetry.PHASES and "scan.sync" in telemetry.PHASES


def test_flight_records_scan_trial_lifecycle():
    """The reference's ``tests/test_scan_loop.py::test_flight_records_scan_trial_lifecycle``:
    one ask and one tell instant a trial, and the chunk and sync spans."""
    from optuna_tpu_torch import flight

    was = flight.enabled(), flight.get_recorder()
    flight.enable(flight.FlightRecorder(capacity=8192))
    try:
        _scan(_study(), _hartmann_objective(), 12, sync_every=6, n_startup_trials=6, seed=0)
        evs = flight.events()
    finally:
        flight.enable(was[1])
        if not was[0]:
            flight.disable()
    trial_events = [e for e in evs if e.kind == "trial"]
    assert sum(e.name == "ask" for e in trial_events) == 12
    assert sum(e.name == "tell" for e in trial_events) == 12
    assert {"scan.chunk", "scan.sync"} <= {e.name for e in evs if e.kind == "phase"}


def test_disabled_telemetry_adds_zero_per_chunk_allocations():
    """With telemetry off the chunk-boundary publish allocates nothing."""
    from optuna_tpu_torch.parallel.scan_loop import _publish_chunk

    stats = {
        "gp.ladder_rung": 0,
        "gp.fit_iterations": 12,
        "scan.rank1_updates": 8,
        "scan.refactorizations": 0,
        "scan.quarantined": 0,
        "scan.chunk_fill": 8,
    }
    for _ in range(200):
        _publish_chunk(stats)
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(10_000):
        _publish_chunk(stats)
    gc.collect()
    assert sys.getallocatedblocks() - before < 500


def test_disabled_run_records_nothing_but_still_quarantines():
    telemetry.reset()
    study = _study()
    _scan(study, _poison_objective(), 16, sync_every=8, n_startup_trials=8, seed=3)
    telemetry.enable(telemetry.get_registry())
    assert device_stats.stat_gauges() == {}
    states = Counter(t.state for t in study.trials)
    assert states.get(TrialState.FAIL, 0) > 0
    assert states.get(TrialState.RUNNING, 0) == 0


# ------------------------------------------------------- sparse (SGPR) chunks


def _sparse_poison_objective(threshold: float = 0.35):
    return _poison_objective(threshold)


def test_nan_quarantine_never_enters_the_inducing_set():
    """Sparse chaos: NaN slots are quarantined and told FAIL (device channel
    == storage truth == containment counter), and the inducing set never
    ingests them: the held-out error and every inducing gauge stay finite."""
    _record()
    study = _study()
    _scan(
        study, _sparse_poison_objective(), 48, sync_every=8, n_startup_trials=8, seed=3,
        n_exact_max=12, n_inducing=8,
    )
    trials = study.trials
    states = Counter(t.state for t in trials)
    assert states.get(TrialState.RUNNING, 0) == 0
    n_fail = states.get(TrialState.FAIL, 0)
    assert n_fail > 0
    gauges = device_stats.stat_gauges()
    startup_fails = sum(1 for t in trials[:8] if t.state == TrialState.FAIL)
    assert int(gauges.get("device.scan.quarantined.total", 0)) == n_fail - startup_fails
    assert telemetry.get_registry().counter_value("executor.quarantine") == n_fail
    m_live = gauges.get("device.gp.inducing_count.last")
    assert m_live is not None and 1 <= m_live <= 16  # pow2 pad of 8
    herr = gauges.get("device.gp.sparse_heldout_err.last")
    assert herr is not None and np.isfinite(herr) and herr >= 0.0
    for t in trials:
        if t.state == TrialState.COMPLETE:
            assert np.isfinite(t.value)
        else:
            assert "quarantined" in t.system_attrs["fail_reason"]


_SCAN_RUNS: dict = {}


def _sparse_scan_study(*, n_exact_max: int, n_trials: int = 88):
    """Run (once per argument tuple: three tests assert different contracts
    on the same run) and return ``(study, stat_gauges)``."""
    key = (n_exact_max, n_trials)
    if key not in _SCAN_RUNS:
        _record()
        study = _study()
        _scan(
            study, _hartmann_objective(), n_trials, sync_every=8, n_startup_trials=8, seed=1,
            n_exact_max=n_exact_max, n_inducing=16,
        )
        _SCAN_RUNS[key] = (study, device_stats.stat_gauges())
    return _SCAN_RUNS[key]


def test_sparse_device_stats_report_the_regime_and_twin_reports_none():
    study, gauges = _sparse_scan_study(n_exact_max=12)
    count = gauges.get("device.gp.inducing_count.last")
    assert count is not None and 1 <= count <= 16
    n_live = sum(1 for t in study.trials if t.state == TrialState.COMPLETE)
    ratio = gauges.get("device.gp.sparsity_ratio.last")
    # count / live rows at the last chunk boundary: within one chunk of the tally.
    assert ratio is not None and 0.0 < ratio <= 1.0
    assert abs(ratio - count / n_live) < count * 8.0 / max(n_live - 8, 1) / n_live + 1e-6
    swaps = gauges.get("device.gp.inducing_swaps.total")
    assert swaps is not None and swaps >= 0 and float(swaps).is_integer()
    herr = gauges.get("device.gp.sparse_heldout_err.last")
    assert herr is not None and np.isfinite(herr) and herr >= 0.0

    _, twin = _sparse_scan_study(n_exact_max=10**9, n_trials=24)
    for stat in (
        "device.gp.inducing_count.last",
        "device.gp.sparsity_ratio.last",
        "device.gp.inducing_swaps.total",
        "device.gp.sparse_heldout_err.last",
    ):
        assert stat not in twin


def test_sparse_scan_steady_state_has_zero_full_refits():
    study, gauges = _sparse_scan_study(n_exact_max=12)
    assert int(gauges["device.scan.refactorizations.total"]) == 0
    assert int(gauges["device.scan.rank1_updates.total"]) > 0
    assert int(gauges.get("device.gp.ladder_rung.max", 0)) <= 2
    best = min(t.value for t in study.trials if t.state == TrialState.COMPLETE)
    assert best < -1.0  # the sparse posterior still optimizes hartmann6


def test_scan_storage_contract_holds_through_the_sparse_switch():
    study, _ = _sparse_scan_study(n_exact_max=12)
    _assert_per_trial_path_state(study, 88, SPACE6)
