"""The rest of the study runtime of the port against the reference, on the CPU.

- Grid, BruteForce and PartialFixed over RandomSampler draw from host NumPy
  in both packages: trial for trial identical (params, states, the grid
  ids, the order of visits, where the study stops).
- PartialFixed over TPE: the reference's draws are handed to the port
  (``tests/_torch_port.py::reference_tpe_draws``); the fixed param is exact,
  the startup trials are bit for bit, and later floats agree within
  ``PARAM_TOL`` of the width, as in ``tests/test_torch_tpe.py``.
- ``MaxTrialsCallback``, the retry clones' ``failed_trial``/``retry_history``
  attrs, ``get_all_study_summaries``, ``copy_study``/``load_study``/
  ``delete_study`` and ``trials_dataframe`` give the reference's values.
- ``optimize(n_jobs=...)``: dense numbers and the states of the reference's
  ``test_optimize_n_jobs_threads_consistent``; an escape halts the budget.
- ``GuardedSampler``: the cases of ``tests/test_sampler_faults.py`` that
  apply to TPE, GP and NSGA-II (CMA-ES is not ported), with host-NumPy runs
  identical to the reference's; and the port's one difference: a device
  fault (a kernel build failure, a CUDA error) propagates under either
  policy.

Tests marked ``cuda`` run the threaded TPE study and the device-fault case
on the card; they skip here.
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch.testing.fault_injection import PATHOLOGICAL_HISTORY_PLANS
from tests._torch_port import cuda_device, heartbeat_storage, reference_tpe_draws  # noqa: F401

PKGS = (optuna_tpu, optuna_tpu_torch)
PARAM_TOL = 5e-5  # TPE past its startup trials: of the transformed width (tests/test_torch_tpe.py)

for _pkg in PKGS:
    _pkg.logging.set_verbosity(_pkg.logging.WARNING)


def _rows(study):
    """Everything about a study's trials that does not depend on the clock."""
    return [
        (t.number, t.state.name, t.params, t.values, t.intermediate_values, t.user_attrs, t.system_attrs)
        for t in study.get_trials(deepcopy=False)
    ]


def _both(fn):
    """``fn(pkg)`` for the reference, then the port."""
    return [fn(pkg) for pkg in PKGS]


# ------------------------------------------------------------------ Grid


GRID = {"x": [0, 1, 2], "y": [-1.5, 0.0, 2.5], "c": ["a", "b", None, True]}


def _grid_objective(trial) -> float:
    x = trial.suggest_int("x", 0, 2)
    y = trial.suggest_float("y", -1.5, 2.5)
    c = trial.suggest_categorical("c", ["a", "b", None, True])
    return x + y + (1.0 if c == "a" else 0.0)


@pytest.mark.parametrize("seed", [0, 7])
def test_grid_visits_the_reference_order_and_stops_when_exhausted(seed):
    def run(pkg):
        study = pkg.create_study(sampler=pkg.samplers.GridSampler(GRID, seed=seed))
        study.optimize(_grid_objective, n_trials=100)
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    assert len(port.trials) == 36
    assert {(t.params["x"], t.params["y"], t.params["c"]) for t in port.trials} == {
        (x, y, c) for x in GRID["x"] for y in GRID["y"] for c in GRID["c"]
    }
    assert port.sampler.is_exhausted(port)


def test_grid_rejects_params_outside_the_grid_as_the_reference():
    for pkg in PKGS:
        study = pkg.create_study(sampler=pkg.samplers.GridSampler({"x": [0.0, 1.0]}, seed=0))
        with pytest.raises(ValueError, match="not found in the given grid"):
            study.optimize(lambda t: t.suggest_float("z", 0, 1), n_trials=1)
        study = pkg.create_study(sampler=pkg.samplers.GridSampler({"x": [0.0, 5.0]}, seed=0))
        with pytest.raises(ValueError, match="out of the range"):
            study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=2)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_grid_under_threads_covers_every_point(pkg):
    """Under ``n_jobs`` two workers may draw one grid point (the host RNG
    picks among the unvisited ids, as in the reference); every point is
    still run, and the study stops once the grid is exhausted."""
    study = pkg.create_study(sampler=pkg.samplers.GridSampler(GRID, seed=3))
    study.optimize(_grid_objective, n_trials=200, n_jobs=4)
    seen = {(t.params["x"], t.params["y"], t.params["c"]) for t in study.trials}
    assert len(seen) == 36
    assert 36 <= len(study.trials) < 200
    assert all(t.state.name == "COMPLETE" for t in study.trials)


# ------------------------------------------------------------ BruteForce


def _mixed_tree(trial) -> float:
    """Int, categorical and stepped float, with a conditional branch: the
    tree grows as the trials discover it."""
    k = trial.suggest_int("k", 0, 2)
    arm = trial.suggest_categorical("arm", ["left", "right"])
    if arm == "left":
        return k + trial.suggest_float("f", 0.0, 0.5, step=0.25)
    return k - trial.suggest_int("j", 1, 2)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("avoid_premature_stop", [False, True])
def test_bruteforce_enumerates_like_the_reference(seed, avoid_premature_stop):
    def run(pkg):
        sampler = pkg.samplers.BruteForceSampler(seed=seed, avoid_premature_stop=avoid_premature_stop)
        study = pkg.create_study(sampler=sampler)
        study.optimize(_mixed_tree, n_trials=100)
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    # 3 ints x (3 floats + 2 ints): every leaf once, then the study stops.
    assert len(port.trials) == 15


def test_bruteforce_counts_failed_and_pruned_leaves_as_the_reference():
    def run(pkg):
        def objective(trial):
            k = trial.suggest_int("k", 0, 5)
            if trial.number % 3 == 1:
                raise pkg.TrialPruned()
            if trial.number % 3 == 2:
                raise ValueError("leaf failure")
            return float(k)

        study = pkg.create_study(sampler=pkg.samplers.BruteForceSampler(seed=2))
        study.optimize(objective, n_trials=30, catch=(ValueError,))
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    assert sorted(t.params["k"] for t in port.trials) == list(range(6))


def test_bruteforce_rejects_a_continuous_float_as_the_reference():
    for pkg in PKGS:
        study = pkg.create_study(sampler=pkg.samplers.BruteForceSampler(seed=0))
        with pytest.raises(ValueError, match="step must be given"):
            study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=1)


# ---------------------------------------------------------- PartialFixed


def _fixed_objective(trial) -> float:
    x = trial.suggest_float("x", -1.0, 1.0)
    lr = trial.suggest_float("lr", 1e-4, 1.0, log=True)
    k = trial.suggest_int("k", 1, 9)
    c = trial.suggest_categorical("c", ["u", "v", "w"])
    return (x - 0.3) ** 2 + math.log10(lr) ** 2 + 0.1 * k + (c == "v")


def test_partial_fixed_over_random_is_identical_trial_for_trial():
    def run(pkg):
        sampler = pkg.samplers.PartialFixedSampler({"x": 0.25, "c": "w"}, pkg.samplers.RandomSampler(seed=4))
        study = pkg.create_study(sampler=sampler)
        study.optimize(_fixed_objective, n_trials=25)
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    assert all(t.params["x"] == 0.25 and t.params["c"] == "w" for t in port.trials)


def test_partial_fixed_out_of_range_value_warns_as_the_reference():
    messages = []
    for pkg in PKGS:
        sampler = pkg.samplers.PartialFixedSampler({"x": 3.0}, pkg.samplers.RandomSampler(seed=0))
        study = pkg.create_study(sampler=sampler)
        with pytest.warns(UserWarning) as record:
            study.optimize(lambda t: t.suggest_float("x", -1.0, 1.0), n_trials=1)
        messages.append([str(w.message) for w in record])
        assert study.trials[0].params["x"] == 3.0
    assert messages[0] == messages[1]


@pytest.mark.usefixtures("reference_tpe_draws")
def test_partial_fixed_over_tpe_matches_the_reference():
    def run(pkg):
        kwargs = {"device": "cpu"} if pkg is optuna_tpu_torch else {}
        base = pkg.samplers.TPESampler(seed=0, n_startup_trials=8, **kwargs)
        study = pkg.create_study(sampler=pkg.samplers.PartialFixedSampler({"k": 4}, base))
        study.optimize(_fixed_objective, n_trials=24)
        return study

    ref, port = _both(run)
    for r, p in zip(ref.trials, port.trials):
        assert p.params["k"] == 4 and r.params["k"] == 4
        if r.number < 8:
            assert p.params == r.params, r.number
            continue
        assert p.params["c"] == r.params["c"], r.number
        for name, lo, hi, log in (("x", -1.0, 1.0, False), ("lr", 1e-4, 1.0, True)):
            f = math.log if log else float
            assert abs(f(p.params[name]) - f(r.params[name])) <= PARAM_TOL * (f(hi) - f(lo)), (r.number, name)


def test_partial_fixed_over_gp_keeps_the_base_device():
    base = optuna_tpu_torch.samplers.GPSampler(
        seed=0, n_startup_trials=4, device="cpu", n_preliminary_samples=128, n_local_search=2
    )
    sampler = optuna_tpu_torch.samplers.PartialFixedSampler({"x0": 0.5}, base)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    study.optimize(lambda t: sum((t.suggest_float(f"x{i}", 0.0, 1.0) - 0.3) ** 2 for i in range(3)), n_trials=7)
    assert sampler._base_sampler._device == torch.device("cpu")
    assert all(t.params["x0"] == 0.5 for t in study.trials)
    for t in study.trials:
        assert t.state.name == "COMPLETE" and all(0.0 <= t.params[f"x{i}"] <= 1.0 for i in (1, 2))
    # The GP fit ran: the relative space is the two free params.
    assert set(sampler.infer_relative_search_space(study, study.trials[-1])) == {"x1", "x2"}


# ------------------------------------------------------------- callbacks


def test_max_trials_callback_stops_where_the_reference_does():
    def run(pkg):
        def objective(trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            if trial.number % 4 == 1:
                raise ValueError("counted only as FAIL")
            return x

        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=1))
        study.optimize(objective, n_trials=50, catch=(ValueError,), callbacks=[pkg.study.MaxTrialsCallback(9)])
        states = (pkg.TrialState.COMPLETE, pkg.TrialState.FAIL)
        other = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=1))
        other.optimize(objective, n_trials=50, catch=(ValueError,),
                       callbacks=[pkg.study.MaxTrialsCallback(9, states=states)])
        return study, other

    (ref, ref_any), (port, port_any) = _both(run)
    assert _rows(port) == _rows(ref) and _rows(port_any) == _rows(ref_any)
    assert sum(t.state.name == "COMPLETE" for t in port.trials) == 9
    assert len(port_any.trials) == 9


def _retry_on_fail(pkg):
    retry = pkg.storages.RetryFailedTrialCallback(max_retry=2)
    return lambda study, trial: retry(study, trial) if trial.state == pkg.TrialState.FAIL else None


def test_retry_clones_carry_the_reference_attrs():
    def run(pkg):
        def objective(trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            trial.report(x, 0)
            if trial.number in (3, 6, 8):  # 6 and 8 are the clones of 3 and of 6
                raise RuntimeError("flaky")
            return x

        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=5))
        study.optimize(objective, n_trials=12, catch=(RuntimeError,), callbacks=[_retry_on_fail(pkg)])
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    rows = {t.number: t for t in port.trials}
    assert rows[4].system_attrs["failed_trial"] == 3 and rows[4].system_attrs["retry_history"] == [3]
    cb = optuna_tpu_torch.storages.RetryFailedTrialCallback
    assert cb.retried_trial_number(rows[4]) == 3 and cb.retry_history(rows[4]) == [3]
    # The callback alias of the top-level module builds the same callback.
    assert isinstance(optuna_tpu_torch._callbacks.RetryFailedTrialCallback(), cb)
    assert optuna_tpu_torch.storages.RetryHeartbeatStaleTrialCallback is cb


def test_retry_clone_inherits_intermediate_values_on_request():
    out = []
    for pkg in PKGS:
        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0))
        trial = study.ask()
        trial.suggest_float("x", 0, 1)
        trial.report(0.5, 3)
        study.tell(trial, state=pkg.TrialState.FAIL)
        pkg.storages.RetryFailedTrialCallback(inherit_intermediate_values=True)(study, study.trials[0])
        out.append(_rows(study))
    assert out[0] == out[1]
    assert out[1][1][4] == {3: 0.5}


# ------------------------------------------------------- study management


def _populate(pkg, storage):
    a = pkg.create_study(storage=storage, study_name="alpha", sampler=pkg.samplers.RandomSampler(seed=0))
    a.set_user_attr("owner", "me")
    a.set_system_attr("note", [1, 2])
    a.optimize(lambda t: (t.suggest_float("x", -1, 1)) ** 2, n_trials=6)
    b = pkg.create_study(
        storage=storage, study_name="beta", directions=["minimize", "maximize"],
        sampler=pkg.samplers.RandomSampler(seed=1),
    )
    b.optimize(lambda t: (t.suggest_float("x", 0, 1), t.suggest_int("k", 0, 4)), n_trials=4)
    pkg.create_study(storage=storage, study_name="empty")
    return storage


def _summary_fields(s):
    best = s.best_trial
    return (
        s.study_name, [d.name for d in s.directions], None if best is None else (best.number, best.values),
        s.user_attrs, s.system_attrs, s.n_trials, s.datetime_start is not None, s._study_id,
    )


def test_study_summaries_and_names_equal_the_reference():
    out = []
    for pkg in PKGS:
        storage = _populate(pkg, pkg.storages.InMemoryStorage())
        summaries = pkg.get_all_study_summaries(storage)
        out.append((pkg.get_all_study_names(storage), [_summary_fields(s) for s in summaries],
                    [_summary_fields(s) for s in pkg.get_all_study_summaries(storage, include_best_trial=False)]))
        assert sorted(summaries) == summaries
    assert out[0] == out[1]
    assert out[1][0] == ["alpha", "beta", "empty"]
    assert isinstance(optuna_tpu_torch.get_all_study_summaries(storage)[0], optuna_tpu_torch.StudySummary)


def test_copy_load_delete_round_trip_as_the_reference():
    out = []
    for pkg in PKGS:
        src = _populate(pkg, pkg.storages.InMemoryStorage())
        dst = pkg.storages.InMemoryStorage()
        pkg.copy_study(from_study_name="alpha", from_storage=src, to_storage=dst)
        pkg.copy_study(from_study_name="beta", from_storage=src, to_storage=dst, to_study_name="beta2")
        alpha = pkg.load_study(study_name="alpha", storage=dst)
        beta = pkg.load_study(study_name="beta2", storage=dst)
        beta_rows, beta_direction = _rows(beta), beta.directions[1].name
        with pytest.raises(ValueError, match="exactly 1 study"):
            pkg.load_study(storage=dst)
        pkg.delete_study(study_name="beta2", storage=dst)
        only = pkg.load_study(storage=dst)  # one study left: the name is optional
        with pytest.raises(KeyError):
            pkg.load_study(study_name="beta2", storage=dst)
        out.append((
            _rows(alpha), alpha.user_attrs, alpha.system_attrs, beta_rows, beta_direction,
            only.study_name, pkg.get_all_study_names(dst), alpha.best_value,
        ))
    assert out[0] == out[1]
    assert out[1][5] == "alpha" and out[1][6] == ["alpha"]


def test_sampler_fallback_knob_on_create_and_load_study():
    storage = optuna_tpu_torch.storages.InMemoryStorage()
    tpe = optuna_tpu_torch.samplers.TPESampler(seed=0, device="cpu")
    study = optuna_tpu_torch.create_study(storage=storage, study_name="s", sampler=tpe, sampler_fallback="independent")
    guarded = optuna_tpu_torch.samplers.GuardedSampler
    assert isinstance(study.sampler, guarded) and study.sampler.sampler is tpe
    again = optuna_tpu_torch.load_study(study_name="s", storage=storage, sampler=study.sampler, sampler_fallback="raise")
    assert again.sampler is study.sampler  # not wrapped twice
    loaded = optuna_tpu_torch.load_study(
        study_name="s", storage=storage, sampler=optuna_tpu_torch.samplers.RandomSampler(), sampler_fallback="raise"
    )
    assert isinstance(loaded.sampler, guarded) and loaded.sampler.fallback == "raise"


@pytest.mark.parametrize("multi_index", [False, True])
@pytest.mark.parametrize("directions", [["minimize"], ["minimize", "maximize"]])
def test_trials_dataframe_equals_the_reference(multi_index, directions):
    pd = pytest.importorskip("pandas")
    frames = []
    for pkg in PKGS:
        study = pkg.create_study(directions=directions, sampler=pkg.samplers.RandomSampler(seed=3))
        if len(directions) == 2:
            study.set_metric_names(["loss", "acc"])

        def objective(trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            trial.set_user_attr("tag", trial.number % 2)
            if trial.number == 2:
                raise pkg.TrialPruned()
            return (x, 1 - x) if len(directions) == 2 else x

        study.optimize(objective, n_trials=5)
        study.enqueue_trial({"x": 0.5})
        frames.append(study.trials_dataframe(multi_index=multi_index))
    ref, port = frames
    assert list(port.columns) == list(ref.columns)
    clock = [c for c in ref.columns if any(w in str(c) for w in ("datetime", "duration"))]
    pd.testing.assert_frame_equal(port.drop(columns=clock), ref.drop(columns=clock))
    for column in clock:
        assert port[column].isna().tolist() == ref[column].isna().tolist()


def test_trials_dataframe_without_pandas_raises_import_error(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pandas(name, *args, **kwargs):
        if name == "pandas" or name.startswith("pandas."):
            raise ImportError("No module named 'pandas'")
        return real_import(name, *args, **kwargs)

    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=2)
    monkeypatch.setattr(builtins, "__import__", no_pandas)
    with pytest.raises(ImportError):
        study.trials_dataframe()


# --------------------------------------------------------------- n_jobs


def _pruning_objective(pkg):
    def objective(trial):
        x = trial.suggest_float("x", -1.0, 1.0)
        for step in range(3):
            trial.report(x * x + step, step)
            if trial.number % 5 == 4 and step == 1:
                raise pkg.TrialPruned()
        return x * x

    return objective


@pytest.mark.parametrize("n_jobs", [2, 4, -1])
def test_n_jobs_threads_give_dense_numbers_and_the_reference_states(n_jobs):
    """The reference's ``test_optimize_n_jobs_threads_consistent``
    (``tests/test_optimize_matrix.py:139``) on both packages."""
    out = []
    for pkg in PKGS:
        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=2))
        study.optimize(_pruning_objective(pkg), n_trials=12, n_jobs=n_jobs)
        assert sorted(t.number for t in study.trials) == list(range(12))
        assert all(t.state.name in ("COMPLETE", "PRUNED") for t in study.trials)
        out.append(sorted((t.number % 5 == 4, t.state.name) for t in study.trials))
    assert out[0] == out[1]


def test_n_jobs_workers_reseed_their_samplers():
    """Every worker of ``n_jobs > 1`` reseeds the shared sampler once, as in
    the reference; the sequential path never does."""
    calls = []

    class Spy(optuna_tpu_torch.samplers.TPESampler):
        def reseed_rng(self):
            calls.append(threading.current_thread().name)
            super().reseed_rng()

    def objective(trial):
        return sum((trial.suggest_float(f"x{i}", -2.0, 2.0) - 0.5) ** 2 for i in range(3))

    sequential = optuna_tpu_torch.create_study(sampler=Spy(seed=0, n_startup_trials=6, device="cpu"))
    sequential.optimize(objective, n_trials=8, n_jobs=1)
    assert calls == []

    study = optuna_tpu_torch.create_study(sampler=Spy(seed=0, n_startup_trials=6, device="cpu"))
    study.optimize(objective, n_trials=32, n_jobs=4)
    assert len(calls) == 4 and len(set(calls)) == 4
    assert threading.current_thread().name not in calls
    assert sorted(t.number for t in study.trials) == list(range(32))


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_an_escape_in_one_worker_halts_the_budget(pkg):
    """Without the halt the other workers would drain the 10,000-trial quota
    (about 17 s of 5 ms trials); with it they stop after their current trial."""
    study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0))
    pause = threading.Event()

    def objective(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        pause.wait(0.005)
        if trial.number == 3:
            raise KeyError("not caught")
        return x

    with pytest.raises(KeyError):
        study.optimize(objective, n_trials=10_000, n_jobs=3)
    assert len(study.trials) < 1000
    assert not study._thread_local.in_optimize_loop

    def callback(study, trial):
        if trial.number == 2:
            raise RuntimeError("callback escape")

    def slow(trial):
        pause.wait(0.005)
        return trial.suggest_float("x", 0, 1)

    other = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0))
    with pytest.raises(RuntimeError, match="callback escape"):
        other.optimize(slow, n_trials=10_000, n_jobs=2, callbacks=[callback])
    assert len(other.trials) < 1000


def test_n_jobs_with_a_timeout_stops_and_nesting_raises():
    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    study.optimize(lambda t: t.suggest_float("x", 0, 1), timeout=0.3, n_jobs=2)
    assert len(study.trials) >= 1

    def nested(trial):
        study.optimize(lambda t: 0.0, n_trials=1)
        return 0.0

    with pytest.raises(RuntimeError, match="Nested invocation"):
        study.optimize(nested, n_trials=1)


@contextlib.contextmanager
def _captured(pkg):
    """The WARNING messages of ``pkg``'s loggers (its library root does not
    propagate to the root logger)."""
    records: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep(logging.WARNING)
    root = logging.getLogger(pkg.__name__)
    level = root.level  # another test module may have set the verbosity higher
    root.setLevel(logging.WARNING)
    root.addHandler(handler)
    try:
        yield records
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def test_progress_bar_runs_and_degrades_as_the_reference(monkeypatch):
    pytest.importorskip("tqdm")
    from optuna_tpu_torch import progress_bar

    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=3, show_progress_bar=True)
    study.optimize(lambda t: t.suggest_float("x", 0, 1), timeout=0.2, show_progress_bar=True)
    messages = {}
    for pkg in PKGS:
        with _captured(pkg) as records:
            other = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0))
            other.optimize(lambda t: t.suggest_float("x", 0, 1), timeout=0.1, n_jobs=2, show_progress_bar=True)
        messages[pkg.__name__] = [m for m in records if "progress bar" in m]
    assert messages["optuna_tpu_torch"] == messages["optuna_tpu"] == [
        "The timeout-based progress bar is not supported with n_jobs != 1."
    ]
    # Without tqdm (the card host has none) the bar is off, with a warning.
    monkeypatch.setattr(progress_bar, "_import_tqdm", lambda: None)
    with _captured(optuna_tpu_torch) as records:
        study.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=2, show_progress_bar=True)
    assert "tqdm is not installed; progress bar is disabled." in records
    assert len(study.trials) >= 6


# ------------------------------------------------------------- heartbeat


def _heartbeat_storage(pkg, interval=1):
    """An in-memory heartbeat storage whose failed-trial callback clones."""
    return heartbeat_storage(pkg, interval, pkg.storages.RetryFailedTrialCallback())


def test_stale_trials_are_reaped_and_retried_as_in_the_reference():
    def run(pkg):
        storage = _heartbeat_storage(pkg)
        study = pkg.create_study(storage=storage, sampler=pkg.samplers.RandomSampler(seed=8))
        with pytest.warns(UserWarning, match="Heartbeat of storage"):
            dead = study.ask()  # a worker that died mid-trial
        dead.suggest_float("x", 0.0, 1.0)
        storage.stale.add(dead._trial_id)
        study.optimize(lambda t: t.suggest_float("x", 0.0, 1.0), n_trials=3)
        assert all(storage.beats.get(t._trial_id, 0) >= 1 for t in study.trials[1:])
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    rows = port.trials
    assert rows[0].state.name == "FAIL" and rows[1].system_attrs["failed_trial"] == 0
    assert rows[1].params == rows[0].params and rows[1].state.name == "COMPLETE"


def test_fail_stale_trials_counts_reaps_and_skips_heartbeatless_storages():
    from optuna_tpu_torch import telemetry
    from optuna_tpu_torch.storages._heartbeat import fail_stale_trials, is_heartbeat_enabled

    plain = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    assert not is_heartbeat_enabled(plain._storage)
    fail_stale_trials(plain)  # a no-op
    storage = _heartbeat_storage(optuna_tpu_torch)
    study = optuna_tpu_torch.create_study(storage=storage, sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ids = [study.ask()._trial_id for _ in range(2)]
    storage.stale.update(ids)
    registry = telemetry.MetricsRegistry()
    telemetry.enable(registry)
    try:
        fail_stale_trials(study)
    finally:
        telemetry.disable()
    assert registry.snapshot()["counters"]["heartbeat.reap"] == 2
    assert [t.state.name for t in study.trials] == ["FAIL", "FAIL", "WAITING", "WAITING"]


def test_heartbeat_thread_beats_while_the_objective_runs():
    from optuna_tpu_torch.storages._heartbeat import HeartbeatThread

    storage = _heartbeat_storage(optuna_tpu_torch, interval=0.02)
    study = optuna_tpu_torch.create_study(storage=storage, sampler=optuna_tpu_torch.samplers.RandomSampler(seed=0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trial_ids = [study.ask()._trial_id for _ in range(2)]
    with HeartbeatThread(trial_ids, storage):
        stop = threading.Event()
        stop.wait(0.15)
    assert all(storage.beats[t] >= 3 for t in trial_ids)


# ---------------------------------------------------------------- utils


def test_lifecycle_decorators_and_deferred_imports_match_the_reference():
    from optuna_tpu import utils as ref_utils
    from optuna_tpu_torch import utils

    out = []
    for mod, exc in ((ref_utils, optuna_tpu.exceptions), (utils, optuna_tpu_torch.exceptions)):
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")

            @mod.experimental_func("1.0")
            def f(a):
                return a + 1

            @mod.deprecated_func("1.0", "2.0", "Use g.")
            def g(a):
                return a * 2

            @mod.experimental_class("1.0")
            class C:
                def __init__(self, v):
                    self.v = v

            @mod.convert_positional_args(previous_positional_arg_names=["a", "b"])
            def h(*, a, b):
                return a - b

            values = (f(1), g(2), C(3).v, h(5, b=2))
        out.append((values, [(w.category.__name__, str(w.message)) for w in record]))
        assert any(issubclass(w.category, exc.ExperimentalWarning) for w in record)
        with mod.try_import() as imported:
            import a_module_that_does_not_exist  # noqa: F401
        assert not imported.is_successful()
        with pytest.raises(ImportError, match="optional dependency"):
            imported.check()
        assert mod._LazyImport("json").dumps([1]) == "[1]"
    assert out[0] == out[1]


# ------------------------------------------------------- GuardedSampler

SPACES = {
    "x": (-1.0, 1.0),
    "y": (0.0, 2.0),
}
BUDGET = 3


def _space(pkg):
    return {name: pkg.distributions.FloatDistribution(lo, hi) for name, (lo, hi) in SPACES.items()}


def _objective(trial):
    x = trial.suggest_float("x", -1.0, 1.0)
    y = trial.suggest_float("y", 0.0, 2.0)
    return (x - 0.2) ** 2 + (y - 1.0) ** 2


def _objective_multi(trial):
    x = trial.suggest_float("x", -1.0, 1.0)
    y = trial.suggest_float("y", 0.0, 2.0)
    return (x - 0.2) ** 2, (y - 1.0) ** 2


def _fallback_trials(study):
    from optuna_tpu_torch.samplers._resilience import SAMPLER_FALLBACK_ATTR_PREFIX

    return sorted(
        t.number for t in study.trials if any(k.startswith(SAMPLER_FALLBACK_ATTR_PREFIX) for k in t.system_attrs)
    )


PORT_SAMPLERS = {
    "tpe": lambda: optuna_tpu_torch.samplers.TPESampler(seed=3, n_startup_trials=2, device="cpu"),
    "gp": lambda: optuna_tpu_torch.samplers.GPSampler(
        seed=3, n_startup_trials=2, device="cpu", n_preliminary_samples=128, n_local_search=2
    ),
    "nsgaii": lambda: optuna_tpu_torch.samplers.NSGAIISampler(seed=3, population_size=4, device="cpu"),
}


@pytest.mark.parametrize("plan", PATHOLOGICAL_HISTORY_PLANS, ids=lambda p: p.name)
@pytest.mark.parametrize("sampler_name", sorted(PORT_SAMPLERS))
def test_guarded_sampler_completes_budget_on_pathological_history(sampler_name, plan):
    multi = sampler_name == "nsgaii"
    guarded = optuna_tpu_torch.samplers.GuardedSampler(PORT_SAMPLERS[sampler_name]())
    study = optuna_tpu_torch.create_study(directions=["minimize"] * (2 if multi else 1), sampler=guarded)
    plan.populate(study, _space(optuna_tpu_torch), seed=11)
    study.optimize(_objective_multi if multi else _objective, n_trials=BUDGET)
    fresh = [t for t in study.trials if t.number >= plan.n_trials]
    assert len(fresh) == BUDGET and all(t.state.name == "COMPLETE" for t in fresh)
    for t in study.trials:
        assert all(math.isfinite(float(v)) for v in t.params.values()), (t.number, t.params)


def test_pathological_plans_equal_the_reference():
    from optuna_tpu.testing import fault_injection as ref_fi
    from optuna_tpu_torch.testing import fault_injection as port_fi

    assert [(p.name, p.description, p.n_trials, p.clone_attrs) for p in port_fi.PATHOLOGICAL_HISTORY_PLANS] == [
        (p.name, p.description, p.n_trials, p.clone_attrs) for p in ref_fi.PATHOLOGICAL_HISTORY_PLANS
    ]
    for ref_plan, port_plan in zip(ref_fi.PATHOLOGICAL_HISTORY_PLANS, port_fi.PATHOLOGICAL_HISTORY_PLANS):
        studies = []
        for pkg, plan in ((optuna_tpu, ref_plan), (optuna_tpu_torch, port_plan)):
            study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0))
            plan.populate(study, _space(pkg), seed=11)
            studies.append(study)
        assert _rows(studies[1]) == _rows(studies[0]), ref_plan.name


def _seed_history(pkg, study, n=2, seed=5):
    rng = np.random.RandomState(seed)
    for i in range(n):
        study.add_trial(
            pkg.create_trial(
                state=pkg.TrialState.COMPLETE,
                params={"x": float(rng.uniform(-1, 1)), "y": float(rng.uniform(0, 2))},
                distributions=_space(pkg),
                values=[float(i)],
            )
        )


def _faulty_study(pkg, fallback="independent", **faults):
    from optuna_tpu.testing import fault_injection as ref_fi
    from optuna_tpu_torch.testing import fault_injection as port_fi

    fi = port_fi if pkg is optuna_tpu_torch else ref_fi
    faulty = fi.FaultySampler(pkg.samplers.RandomSampler(seed=1), force_relative=True, **faults)
    study = pkg.create_study(sampler=pkg.samplers.GuardedSampler(faulty, fallback=fallback))
    _seed_history(pkg, study)
    return study


def test_raising_sampler_falls_back_on_exactly_the_faulted_trials_as_the_reference():
    def run(pkg):
        study = _faulty_study(pkg, raise_at={1, 3})
        study.optimize(_objective, n_trials=6)
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    assert _fallback_trials(port) == [3, 5]
    assert "injected sampler crash" in port.trials[3].system_attrs["sampler_fallback:relative"]


def test_nan_proposals_never_stored_as_the_reference():
    from optuna_tpu_torch.samplers._resilience import non_finite_param_names

    def run(pkg):
        study = _faulty_study(pkg, nan_at={0, 2})
        study.optimize(_objective, n_trials=5)
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    assert _fallback_trials(port) == [2, 4]
    assert all(not non_finite_param_names(t.params) for t in port.trials)
    assert "non-finite proposal" in port.trials[2].system_attrs["sampler_fallback:relative"]


def test_raise_policy_surfaces_the_error_after_recording_as_the_reference():
    def run(pkg):
        study = _faulty_study(pkg, fallback="raise", raise_at={0})
        with pytest.raises(RuntimeError, match="injected sampler crash"):
            study.optimize(_objective, n_trials=2)
        return study

    ref, port = _both(run)
    assert _rows(port) == _rows(ref)
    assert _fallback_trials(port) == [2] and port.trials[2].state.name == "FAIL"


def test_guarded_sampler_rejects_unknown_policy_and_is_not_wrapped_twice():
    guarded = optuna_tpu_torch.samplers.GuardedSampler
    with pytest.raises(ValueError, match="fallback must be one of"):
        guarded(optuna_tpu_torch.samplers.RandomSampler(), fallback="shrug")
    tpe = optuna_tpu_torch.samplers.TPESampler(seed=0, device="cpu")
    study = optuna_tpu_torch.create_study(sampler=guarded(tpe), sampler_fallback="independent")
    assert study.sampler.sampler is tpe
    from optuna_tpu.samplers import _resilience as ref_res
    from optuna_tpu_torch.samplers import _resilience as port_res

    assert port_res.FALLBACK_POLICIES == ref_res.FALLBACK_POLICIES
    assert port_res.SAMPLER_FALLBACK_ATTR_PREFIX == ref_res.SAMPLER_FALLBACK_ATTR_PREFIX


@pytest.mark.parametrize("name", sorted(PORT_SAMPLERS))
def test_fault_free_wrapped_runs_are_bit_identical(name):
    multi = name == "nsgaii"
    runs = []
    for wrap in (False, True):
        sampler = PORT_SAMPLERS[name]()
        if wrap:
            sampler = optuna_tpu_torch.samplers.GuardedSampler(sampler)
        study = optuna_tpu_torch.create_study(directions=["minimize"] * (2 if multi else 1), sampler=sampler)
        study.optimize(_objective_multi if multi else _objective, n_trials=10 if multi else 6)
        runs.append(study)
    plain, guarded = runs
    assert _fallback_trials(guarded) == []
    assert [t.params for t in plain.trials] == [t.params for t in guarded.trials]
    assert [t.values for t in plain.trials] == [t.values for t in guarded.trials]


def test_fit_deadline_on_a_fake_clock_and_on_the_wall_clock():
    from optuna_tpu_torch.testing.fault_injection import FaultySampler

    ticks = iter([0.0, 1000.0, 2000.0])
    faulty = FaultySampler(
        optuna_tpu_torch.samplers.RandomSampler(seed=1), hang_at={0}, hang_s=0.3, force_relative=True
    )
    study = optuna_tpu_torch.create_study(
        sampler=optuna_tpu_torch.samplers.GuardedSampler(faulty, fit_deadline_s=60.0, clock=lambda: next(ticks))
    )
    _seed_history(optuna_tpu_torch, study)
    study.optimize(_objective, n_trials=1)
    assert _fallback_trials(study) == [2]
    reason = study.trials[2].system_attrs["sampler_fallback:relative"]
    assert "DispatchTimeoutError" in reason and "deadline" in reason

    faulty = FaultySampler(
        optuna_tpu_torch.samplers.RandomSampler(seed=1), hang_at={0}, hang_s=1.5, force_relative=True
    )
    study = optuna_tpu_torch.create_study(
        sampler=optuna_tpu_torch.samplers.GuardedSampler(faulty, fit_deadline_s=0.5)
    )
    _seed_history(optuna_tpu_torch, study)
    study.optimize(_objective, n_trials=3)
    assert all(t.state.name == "COMPLETE" for t in study.trials)
    assert _fallback_trials(study) == [2]


def test_run_with_deadline_passes_results_and_errors_through():
    from optuna_tpu_torch.parallel.executor import DispatchTimeoutError, run_with_deadline

    assert run_with_deadline(lambda: 7, 5.0) == 7
    with pytest.raises(ZeroDivisionError):
        run_with_deadline(lambda: 1 / 0, 5.0)
    ticks = iter([0.0, 10.0])
    release = threading.Event()
    with pytest.raises(DispatchTimeoutError, match="exceeded the 1.0s deadline"):
        run_with_deadline(release.wait, 1.0, clock=lambda: next(ticks))
    release.set()
    assert issubclass(DispatchTimeoutError, TimeoutError)


def test_fallback_attrs_survive_retry_clone_stripping():
    from optuna_tpu_torch.storages._callbacks import EXECUTOR_ATTR_PREFIX

    study = optuna_tpu_torch.create_study()
    study.add_trial(
        optuna_tpu_torch.create_trial(
            state=optuna_tpu_torch.TrialState.FAIL,
            params={"x": 0.1, "y": 1.0},
            distributions=_space(optuna_tpu_torch),
            system_attrs={
                "sampler_fallback:relative": "RuntimeError: boom",
                EXECUTOR_ATTR_PREFIX + "dispatch": {"batch": "a/0", "slot": 3},
                "fail_reason": "batch dispatch raised",
            },
        )
    )
    optuna_tpu_torch.storages.RetryFailedTrialCallback()(study, study.trials[0])
    attrs = study.trials[1].system_attrs
    assert attrs["sampler_fallback:relative"] == "RuntimeError: boom"
    assert not any(k.startswith(EXECUTOR_ATTR_PREFIX) for k in attrs) and "fail_reason" not in attrs
    assert attrs["fixed_params"] == {"x": 0.1, "y": 1.0}


def test_pins_export_and_batch_pass_through():
    guarded = optuna_tpu_torch.samplers.GuardedSampler(
        optuna_tpu_torch.samplers.TPESampler(seed=0, n_startup_trials=2, device="cpu")
    )
    study = optuna_tpu_torch.create_study(sampler=guarded)
    token = guarded.pin_independent(2)
    assert guarded.pinned_remaining == 2
    study.optimize(_objective, n_trials=4)
    assert guarded.pinned_remaining == 0 and guarded.unpin_independent(token) == 0
    assert guarded.export_fitted_state() is None and guarded.restore_fitted_state({}) is False
    space = _space(optuna_tpu_torch)
    batch = guarded.sample_relative_batch(study, space, 3)
    inner = guarded.sampler.sample_relative_batch
    assert batch is not None and len(batch) == 3 and callable(inner)
    plain = optuna_tpu_torch.samplers.GuardedSampler(optuna_tpu_torch.samplers.RandomSampler(seed=0))
    assert plain.sample_relative_batch(study, space, 3) is None  # no batch hook: the per-trial path


class _SlowReadDict(dict):
    """A dict whose item read yields the GIL before and after it, so that a
    thread between listing the tokens and reading one, or between reading a
    count and writing it back, is overtaken by the others."""

    def __getitem__(self, key):
        time.sleep(0.0001)
        value = super().__getitem__(key)
        time.sleep(0.0001)
        return value


def test_pins_are_consumed_exactly_from_concurrent_workers():
    """Four threads consume one 800-suggestion pin while another thread sets
    and undoes one-suggestion pins: no thread sees a token vanish
    mid-consume, and no decrement of the long pin is lost."""
    guarded = optuna_tpu_torch.samplers.GuardedSampler(optuna_tpu_torch.samplers.RandomSampler(seed=0))
    guarded._pins = _SlowReadDict()
    long_pin = guarded.pin_independent(800)
    pinned, errors = [], []
    start, done = threading.Barrier(5), threading.Event()

    def consume():
        start.wait()
        try:
            pinned.append(sum(guarded._consume_pin(1) for _ in range(200)))
        except Exception as err:  # noqa: BLE001 - recorded for the assertion
            errors.append(err)

    def churn():
        start.wait()
        while not done.is_set():
            guarded.unpin_independent(guarded.pin_independent(1))
            time.sleep(0.0001)

    consumers = [threading.Thread(target=consume) for _ in range(4)]
    churner = threading.Thread(target=churn)
    for t in (*consumers, churner):
        t.start()
    for t in consumers:
        t.join()
    done.set()
    churner.join()
    assert errors == [] and sum(pinned) == 800
    assert guarded.unpin_independent(long_pin) == 0 and guarded.pinned_remaining == 0


# ------------------------------------------- device faults are not contained


def _device_faults():
    from optuna_tpu_torch.ops.kernels._nvcc import KernelBuildError

    faults = {
        "kernel_build": lambda i: KernelBuildError("nvcc failed on matern52_gram.cu"),
        "cuda_runtime": lambda i: RuntimeError("CUDA error: an illegal memory access was encountered"),
        "kernel_launch": lambda i: RuntimeError("rank_fronts kernel launch failed: CUDA error 700."),
    }
    if hasattr(torch, "AcceleratorError"):
        faults["accelerator"] = lambda i: torch.AcceleratorError("CUDA error: device-side assert triggered")
    return faults


@pytest.mark.parametrize("fallback", ["independent", "raise"])
@pytest.mark.parametrize("fault", sorted(_device_faults()))
def test_device_faults_propagate_under_either_policy(fault, fallback):
    from optuna_tpu_torch.testing.fault_injection import FaultySampler

    make = _device_faults()[fault]
    faulty = FaultySampler(
        optuna_tpu_torch.samplers.RandomSampler(seed=1), raise_at={1}, force_relative=True, error_factory=make
    )
    study = optuna_tpu_torch.create_study(
        sampler=optuna_tpu_torch.samplers.GuardedSampler(faulty, fallback=fallback)
    )
    _seed_history(optuna_tpu_torch, study)
    with pytest.raises(type(make(0))):
        study.optimize(_objective, n_trials=5)
    assert [t.state.name for t in study.trials] == ["COMPLETE"] * 3 + ["FAIL"]
    assert _fallback_trials(study) == []  # nothing recorded, no host fallback


@pytest.mark.parametrize("hook", ["infer_relative_search_space", "sample_independent", "before_trial", "after_trial"])
def test_device_faults_propagate_from_every_hook(hook):
    """From ``after_trial`` the fault escapes the tell, where the loop's
    announcement of the still-RUNNING trial raises over it, as in the
    reference; the fault is the exception's context."""
    from optuna_tpu_torch.ops.kernels._nvcc import KernelBuildError

    class Broken(optuna_tpu_torch.samplers.RandomSampler):
        pass

    def boom(self, *args, **kwargs):
        raise KernelBuildError("nvcc not found")

    setattr(Broken, hook, boom)
    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.GuardedSampler(Broken(seed=0)))
    with pytest.raises((KernelBuildError, AssertionError)) as info:
        study.optimize(_objective, n_trials=2)
    err = info.value
    assert isinstance(err if hook != "after_trial" else err.__context__, KernelBuildError)
    assert _fallback_trials(study) == []


def test_is_device_fault_tells_device_faults_from_sampler_faults():
    from optuna_tpu_torch.ops.kernels._nvcc import KernelBuildError
    from optuna_tpu_torch.samplers._resilience import is_device_fault

    for make in _device_faults().values():
        assert is_device_fault(make(0))
    assert issubclass(KernelBuildError, RuntimeError)
    for err in (RuntimeError("injected sampler crash"), ValueError("CUDA error"), torch.linalg.LinAlgError("x")):
        assert not is_device_fault(err)


def test_nvcc_failures_raise_kernel_build_error(monkeypatch, tmp_path):
    from optuna_tpu_torch.ops.kernels import _nvcc

    monkeypatch.setattr(_nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(_nvcc.os.path, "exists", lambda path: False)
    with pytest.raises(_nvcc.KernelBuildError, match="nvcc not found"):
        _nvcc.find_nvcc()


def _cdll_that_fails(path):
    raise OSError(f"{path}: undefined symbol: _ZN3c104cuda")


@pytest.mark.parametrize("fallback", ["independent", "raise"])
@pytest.mark.parametrize(
    "cdll", [_cdll_that_fails, lambda path: object()], ids=["library_does_not_load", "entry_point_missing"]
)
def test_a_library_that_does_not_load_propagates_as_a_kernel_build_error(monkeypatch, tmp_path, cdll, fallback):
    """A built library that ``ctypes`` cannot load (``OSError``) or that
    lacks K1's entry point (``AttributeError`` in its binder) is a
    ``KernelBuildError``: ``GuardedSampler`` lets it through from
    ``sample_relative`` and records no fallback."""
    from optuna_tpu_torch.ops.kernels import _nvcc, matern

    monkeypatch.setattr(_nvcc, "build", lambda source: tmp_path / "libmatern52_gram.so")
    monkeypatch.setattr(_nvcc.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_nvcc, "_loaded", {})
    matern._lib.cache_clear()

    class NeedsK1(optuna_tpu_torch.samplers.RandomSampler):
        def infer_relative_search_space(self, study, trial):
            return _space(optuna_tpu_torch)

        def sample_relative(self, study, trial, search_space):
            matern._lib()
            return {}

    study = optuna_tpu_torch.create_study(
        sampler=optuna_tpu_torch.samplers.GuardedSampler(NeedsK1(seed=0), fallback=fallback)
    )
    with pytest.raises(_nvcc.KernelBuildError, match="could not be loaded or bound") as info:
        study.optimize(_objective, n_trials=2)
    assert isinstance(info.value.__cause__, (OSError, AttributeError))
    assert _nvcc._loaded == {}  # nothing published
    assert _fallback_trials(study) == []
    assert [t.state.name for t in study.trials] == ["FAIL"]


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_tpe_on_the_card_under_four_threads(cuda_device):  # noqa: F811
    from optuna_tpu_torch.models.benchmarks import highdim_mixed

    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.TPESampler(seed=0))
    study.optimize(highdim_mixed, n_trials=60, n_jobs=4)
    assert study.sampler.device.type == "cuda"
    assert sorted(t.number for t in study.trials) == list(range(60))
    assert all(t.state.name == "COMPLETE" for t in study.trials)
    points = [tuple(sorted(t.params.items(), key=lambda kv: kv[0])) for t in study.trials]
    assert len(set(points)) == 60


@pytest.mark.cuda
def test_kernel_build_error_on_the_card_propagates(cuda_device, monkeypatch):  # noqa: F811
    """A failed build of K1 under a sparse GP ask on the card propagates
    through ``GuardedSampler`` (no host fallback)."""
    from optuna_tpu_torch.ops.kernels import _nvcc, matern

    def broken_build(source):
        raise _nvcc.KernelBuildError(f"nvcc failed on {source}")

    matern._lib.cache_clear()
    monkeypatch.setattr(_nvcc, "_loaded", {})
    monkeypatch.setattr(_nvcc, "build", broken_build)
    sampler = optuna_tpu_torch.samplers.GPSampler(seed=0, n_startup_trials=2, n_exact_max=8, n_inducing=4)
    study = optuna_tpu_torch.create_study(sampler=optuna_tpu_torch.samplers.GuardedSampler(sampler))
    rng = np.random.default_rng(0)
    dists = {f"x{i}": optuna_tpu_torch.distributions.FloatDistribution(0.0, 1.0) for i in range(3)}
    for _ in range(12):
        x = rng.uniform(size=3)
        study.add_trial(optuna_tpu_torch.create_trial(
            params={f"x{i}": float(x[i]) for i in range(3)}, distributions=dists, value=float(x.sum())))
    try:
        with pytest.raises(_nvcc.KernelBuildError):
            study.optimize(lambda t: sum(t.suggest_float(f"x{i}", 0.0, 1.0) for i in range(3)), n_trials=1)
    finally:
        matern._lib.cache_clear()
    assert _fallback_trials(study) == []
