"""The port's batched trial execution against the reference, on the CPU.

``Study.ask_batch``, ``parallel.optimize_vectorized`` and its executor run
in both packages from the same seeds (the port with ``device="cpu"``; the
reference's objective is a ``jnp`` program, the port's the same
expression in torch):

- a ``RandomSampler`` study: params bit for bit (host NumPy draws on both
  sides), values within ``VALUE_RTOL`` (float32 evaluation of the same
  float32 inputs; the two frameworks may order the operations apart);
- TPE (multivariate, constant liar) through its batch hook, with the
  reference's draws handed to the port (``tests/_torch_port.py::
  reference_tpe_draws``): the startup trials bit for bit, the batched
  proposals within ``PARAM_TOL`` of each width (``tests/test_torch_tpe.py``);
- one ``FaultyVectorizedObjective`` plan of each kind (NaN, crash, OOM,
  worker death, hang, persistent poison, OOM inside bisection) on both: the
  same trial states, the same ``dispatch_widths``, the same system attrs
  (``batch_exec:`` and ``sampler_fallback:`` included) with the run token of
  the batch tags left out;
- the cases of ``tests/test_parallel.py`` without a mesh,
  ``tests/test_executor_fastpath.py`` and the executor half of
  ``tests/test_sampler_faults.py``.

A one-rank ``mesh`` dispatches through the sharded tier's
``MeshDispatch`` and runs trial for trial as the mesh-less loop;
``device=None`` is the card and raises without one.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu.parallel
import optuna_tpu.testing.fault_injection
import optuna_tpu_torch
import optuna_tpu_torch.testing.fault_injection
from optuna_tpu_torch import telemetry
from optuna_tpu_torch.distributions import FloatDistribution
from optuna_tpu_torch.parallel import VectorizedObjective, optimize_vectorized
from optuna_tpu_torch.samplers import GuardedSampler, RandomSampler, TPESampler
from optuna_tpu_torch.samplers._resilience import SAMPLER_FALLBACK_ATTR_PREFIX, non_finite_param_names
from optuna_tpu_torch.storages import _heartbeat
from optuna_tpu_torch.storages._callbacks import EXECUTOR_ATTR_PREFIX
from optuna_tpu_torch.trial._state import TrialState
from tests._torch_port import heartbeat_storage, join_abandoned_dispatches, one_torch_thread, reference_tpe_draws  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "join_abandoned_dispatches")

PKGS = (optuna_tpu, optuna_tpu_torch)
VALUE_RTOL = 1e-6  # float32 objective values from the same float32 inputs
PARAM_TOL = 5e-5  # TPE proposals past startup, of the width (tests/test_torch_tpe.py)

for _pkg in PKGS:
    _pkg.logging.set_verbosity(_pkg.logging.ERROR)


def _opt(pkg):
    """``optimize_vectorized`` of ``pkg``; the port's on the CPU."""
    if pkg is optuna_tpu_torch:
        return functools.partial(optimize_vectorized, device="cpu")
    return optuna_tpu.parallel.optimize_vectorized


def _quad(params):
    return (params["x"] - 0.3) ** 2


def _space(pkg, **bounds):
    return {k: pkg.distributions.FloatDistribution(lo, hi) for k, (lo, hi) in bounds.items()}


def _rows(study):
    """States, params, values and system attrs, with the executor's run token
    left out of the batch tags (``<pid>.<seq>/<batch>`` -> ``<batch>``)."""
    rows = []
    for t in study.get_trials(deepcopy=False):
        attrs = dict(t.system_attrs)
        tag = attrs.get(EXECUTOR_ATTR_PREFIX + "dispatch")
        if tag is not None:
            attrs[EXECUTOR_ATTR_PREFIX + "dispatch"] = (tag["batch"].split("/")[1], tag["slot"])
        rows.append((t.number, t.state.name, t.params, attrs))
    return rows


def _assert_values_close(ref, port):
    for r, p in zip(ref.trials, port.trials):
        if r.values is None or p.values is None:
            assert r.values is None and p.values is None, r.number
            continue
        np.testing.assert_allclose(p.values, r.values, rtol=VALUE_RTOL, atol=1e-12)


# ------------------------------------------------------ studies, both sides


def test_random_study_matches_reference():
    def run(pkg):
        space = _space(pkg, x=(-3.0, 3.0), y=(-3.0, 3.0))
        fn = lambda p: (p["x"] - 1.0) ** 2 + (p["y"] + 1.0) ** 2  # noqa: E731
        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0))
        _opt(pkg)(study, pkg.parallel.VectorizedObjective(fn, space), n_trials=20, batch_size=8)
        return study

    ref, port = (run(pkg) for pkg in PKGS)
    assert len(port.trials) == 20 and all(t.state == TrialState.COMPLETE for t in port.trials)
    assert _rows(port) == _rows(ref)
    _assert_values_close(ref, port)


def test_multiobjective_study_matches_reference():
    def run(pkg, stack):
        study = pkg.create_study(directions=["minimize", "minimize"], sampler=pkg.samplers.RandomSampler(seed=0))
        fn = lambda p: stack([p["x"], 1.0 - p["x"]], -1)  # noqa: E731
        _opt(pkg)(study, pkg.parallel.VectorizedObjective(fn, _space(pkg, x=(0.0, 1.0))), n_trials=16, batch_size=8)
        return study

    import jax.numpy as jnp

    ref, port = run(optuna_tpu, jnp.stack), run(optuna_tpu_torch, torch.stack)
    assert all(len(t.values) == 2 for t in port.trials)
    assert _rows(port) == _rows(ref)
    _assert_values_close(ref, port)


@pytest.mark.usefixtures("reference_tpe_draws")
def test_tpe_batches_match_reference():
    """48 trials in batches of 8: 8 startup trials (host draws), then five
    batches, each one ``sample_relative_batch`` of the top 8 of 96 joint
    candidates."""

    def run(pkg, sampler):
        fn = lambda p: (p["x"] - 1.0) ** 2 + (p["y"] + 1.0) ** 2  # noqa: E731
        study = pkg.create_study(sampler=sampler)
        obj = pkg.parallel.VectorizedObjective(fn, _space(pkg, x=(-3.0, 3.0), y=(-3.0, 3.0)))
        _opt(pkg)(study, obj, n_trials=48, batch_size=8)
        return study

    kwargs = dict(seed=0, multivariate=True, constant_liar=True, n_startup_trials=8)
    ref = run(optuna_tpu, optuna_tpu.samplers.TPESampler(**kwargs))
    port = run(optuna_tpu_torch, TPESampler(device="cpu", **kwargs))
    assert len(port.trials) == 48 and all(t.state == TrialState.COMPLETE for t in port.trials)
    for r, p in zip(ref.trials, port.trials):
        if r.number < 8:
            assert r.params == p.params, r.number
        else:
            for name in ("x", "y"):
                assert abs(r.params[name] - p.params[name]) <= PARAM_TOL * 6.0, (r.number, r.params, p.params)
    assert port.best_value < 1.0
    assert abs(port.best_value - ref.best_value) <= 1e-3


# ------------------------------------------------- fault plans, both sides


FAULT_PLANS = {
    "nan": (0, 16, {"nan_at": {0: (1, 4)}}, {}),
    "crash": (3, 8, {"raise_at": {0}}, {}),
    "oom": (1, 16, {"oom_above": 4}, {}),
    "oom_in_bisection": (8, 28, {"oom_at": {0, 4}, "raise_at": {3}}, {}),
    "poison": (5, 8, {"raise_when": lambda host: bool((host["x"] > 0.9).any())}, {}),
    "hang": (2, 8, {"hang_at": {0}, "hang_s": 2.0}, {"dispatch_deadline_s": 0.5}),
    "kill": (0, 24, {"kill_at": {1}}, {}),
}


@pytest.mark.parametrize("plan", list(FAULT_PLANS))
def test_fault_plan_matches_reference(plan):
    seed, n_trials, faults, options = FAULT_PLANS[plan]

    def run(pkg):
        kit = pkg.testing.fault_injection
        storage = heartbeat_storage(pkg)
        study = pkg.create_study(storage=storage, sampler=pkg.samplers.RandomSampler(seed=seed))
        obj = kit.FaultyVectorizedObjective(_quad, _space(pkg, x=(0.0, 1.0)), **faults)
        # Compile the reference's program at every width first, so that no
        # compile counts against the dispatch deadline (nor changes the plan).
        warm = obj._inner.guarded(None, "trials", "fail")
        for width in (8, 4, 2, 1):
            x = np.zeros(width, np.float32)
            warm({"x": torch.from_numpy(x) if pkg is optuna_tpu_torch else x})
        policy = pkg.storages.RetryPolicy(max_attempts=5, sleep=lambda _s: None)
        try:
            _opt(pkg)(study, obj, n_trials=n_trials, batch_size=8, retry_policy=policy, **options)
        except kit.SimulatedWorkerDeath:
            assert plan == "kill"
        return study, obj.dispatch_widths

    (ref, ref_widths), (port, port_widths) = (run(pkg) for pkg in PKGS)
    assert port_widths == ref_widths
    assert _rows(port) == _rows(ref)
    _assert_values_close(ref, port)
    running = sum(t.state == TrialState.RUNNING for t in port.trials)
    assert running == (8 if plan == "kill" else 0)


class _BatchRaisingRandom:
    """A RandomSampler of either package whose batch hook raises."""

    @staticmethod
    def make(pkg, seed=0):
        class Sampler(pkg.samplers.RandomSampler):
            def sample_relative_batch(self, study, search_space, n):
                raise RuntimeError("batch fit crashed")

        return Sampler(seed=seed)


def test_sampler_fallback_attrs_match_reference():
    def run(pkg):
        study = pkg.create_study(storage=heartbeat_storage(pkg), sampler=_BatchRaisingRandom.make(pkg))
        obj = pkg.parallel.VectorizedObjective(_quad, _space(pkg, x=(0.0, 1.0)))
        _opt(pkg)(study, obj, n_trials=8, batch_size=4)
        return study

    ref, port = (run(pkg) for pkg in PKGS)
    assert _rows(port) == _rows(ref)
    assert all(
        "batch fit crashed" in t.system_attrs[SAMPLER_FALLBACK_ATTR_PREFIX + "relative_batch"] for t in port.trials
    )


# ---------------------------------------------------------------- ask_batch


def test_ask_batch_one_commit_semantics(monkeypatch):
    """``ask_batch`` equals n sequential asks, through one storage batch;
    WAITING trials are claimed first and keep their fixed params."""

    def run(pkg):
        study = pkg.create_study(sampler=pkg.samplers.RandomSampler(seed=0))
        study.enqueue_trial({"x": 0.25})
        calls = []
        original = study._storage.create_new_trials
        monkeypatch.setattr(
            study._storage, "create_new_trials", lambda sid, n, *a: (calls.append(n), original(sid, n, *a))[1]
        )
        trials = study.ask_batch(5)
        for t in trials:
            t.suggest_float("x", 0.0, 1.0)
            study.tell(t, 0.0)
        return study, calls, [t.number for t in trials]

    (ref, ref_calls, ref_numbers), (port, calls, numbers) = (run(pkg) for pkg in PKGS)
    assert numbers == ref_numbers == [0, 1, 2, 3, 4]
    assert calls == ref_calls == [4]  # the four fresh trials in one storage batch
    assert port.trials[0].params["x"] == 0.25
    assert _rows(port) == _rows(ref)


def test_ask_batch_init_error_fails_and_requeues_every_claimed_trial(tmp_path):
    """An error while initializing the batch FAILs every trial claimed or
    created (with the reason), fires the storage's failed-trial callback
    (the claimed WAITING clone is enqueued again), then re-raises."""

    def run(pkg):
        class Exploding(pkg.samplers.RandomSampler):
            def before_trial(self, study, trial):
                if trial.number == 2:
                    raise RuntimeError("before_trial exploded")

        storage = pkg.storages.RDBStorage(
            f"sqlite:///{tmp_path}/{pkg.__name__}.db", heartbeat_interval=60, grace_period=120,
            failed_trial_callback=pkg.storages.RetryFailedTrialCallback(),
        )
        study = pkg.create_study(storage=storage, sampler=Exploding(seed=0))
        study.enqueue_trial({"x": 0.5})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the heartbeat warning outside an optimize loop
            with pytest.raises(RuntimeError, match="before_trial exploded"):
                study.ask_batch(3)
        return study

    ref, port = (run(pkg) for pkg in PKGS)
    assert [t.state.name for t in port.trials] == ["FAIL", "FAIL", "FAIL", "WAITING", "WAITING", "WAITING"]
    assert all("batch ask aborted" in t.system_attrs["fail_reason"] for t in port.trials[:3])
    assert _rows(port) == _rows(ref)


def test_ask_batch_warns_about_heartbeats_outside_an_optimize_loop():
    study = optuna_tpu_torch.create_study(storage=heartbeat_storage(optuna_tpu_torch), sampler=RandomSampler(seed=0))
    with pytest.warns(UserWarning, match="Heartbeat of storage"):
        study.ask_batch(2)


# ------------------------------------------------- the objective's wrappers


def test_compiled_objective_cached_across_optimize_calls():
    obj = VectorizedObjective(fn=lambda p: p["x"] * 2.0, search_space={"x": FloatDistribution(0.0, 1.0)})
    assert obj.compiled(None, "trials") is obj.compiled(None, "trials")
    assert obj.guarded(None, "trials") is obj.guarded(None, "trials")
    assert obj.guarded(None, "trials", "fail") is obj.guarded(None, "trials", "raise")
    assert obj.guarded(None, "trials", "clip") is not obj.guarded(None, "trials", "fail")
    before = len(obj._compiled_cache)
    for _ in range(2):
        study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
        optimize_vectorized(study, obj, n_trials=4, batch_size=4, device="cpu")
        assert len(study.trials) == 4
    assert len(obj._compiled_cache) == before


def test_pack_params_float32_values_and_int32_choice_indices():
    from optuna_tpu_torch.distributions import CategoricalDistribution, IntDistribution
    from optuna_tpu_torch.parallel.vectorized import _pack_params

    space = {
        "x": FloatDistribution(1e-3, 1.0, log=True),
        "k": IntDistribution(1, 9),
        "c": CategoricalDistribution(["a", "b", "c"]),
    }
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    trials = study.ask_batch(3)
    for t, c in zip(trials, "cab"):
        t.suggest_float("x", 1e-3, 1.0, log=True)
        t.suggest_int("k", 1, 9)
        t.suggest_categorical("c", ["a", "b", "c"])
    packed = _pack_params(trials, space)
    assert packed["x"].dtype == np.float32 and packed["k"].dtype == np.float32
    assert packed["c"].dtype == np.int32
    assert list(packed["c"]) == [["a", "b", "c"].index(t.params["c"]) for t in trials]
    assert np.array_equal(packed["x"], np.float32([t.params["x"] for t in trials]))


def test_a_mesh_names_the_sharded_tier_and_the_default_device_is_the_card():
    """A one-rank CPU mesh dispatches through the sharded tier and equals
    the mesh-less run trial for trial; with no mesh, ``device=None`` is the
    card."""
    from optuna_tpu_torch.parallel import build_study_mesh

    space = {"x": FloatDistribution(0.0, 1.0)}
    obj = VectorizedObjective(_quad, space)
    mesh = build_study_mesh({"trials": 1, "model": 1}, device="cpu")
    assert obj.guarded(mesh, "trials").mesh is mesh  # the wrapper is the tier's MeshDispatch
    plain = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(plain, VectorizedObjective(_quad, space), n_trials=6, batch_size=4, device="cpu")
    meshed = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(meshed, obj, n_trials=6, batch_size=4, mesh=mesh)
    assert [(t.params, t.state, t.values) for t in meshed.trials] == [(t.params, t.state, t.values) for t in plain.trials]
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            optimize_vectorized(study, obj, n_trials=4)
    assert len(study.trials) == 0


def test_one_host_read_a_dispatch(monkeypatch):
    """The values and the finite mask come back in one ``.cpu()``."""
    reads = []
    original = torch.Tensor.cpu

    def counting(self, *args, **kwargs):
        reads.append(tuple(self.shape))
        return original(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    study = optuna_tpu_torch.create_study(directions=["minimize"] * 2, sampler=RandomSampler(seed=0))
    obj = VectorizedObjective(lambda p: torch.stack([p["x"], 1 - p["x"]], -1), {"x": FloatDistribution(0.0, 1.0)})
    optimize_vectorized(study, obj, n_trials=12, batch_size=8, device="cpu")
    assert reads == [(8, 3), (4, 3)]


# ---------------------------------------------------- the fault-free fast path


class _Spy:
    """Counts every HeartbeatThread construction."""

    def __init__(self, monkeypatch):
        self.constructed = 0
        original = _heartbeat.HeartbeatThread.__init__

        def spying_init(hb_self, trial_id, heartbeat):
            self.constructed += 1
            return original(hb_self, trial_id, heartbeat)

        monkeypatch.setattr(_heartbeat.HeartbeatThread, "__init__", spying_init)


def _fast_objective():
    return VectorizedObjective(lambda p: (p["x"] - 0.3) ** 2, {"x": FloatDistribution(0.0, 1.0)})


def test_no_heartbeat_thread_on_heartbeat_less_storage(monkeypatch):
    spy = _Spy(monkeypatch)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(study, _fast_objective(), n_trials=12, batch_size=4, device="cpu")
    assert spy.constructed == 0
    assert all(t.state == TrialState.COMPLETE for t in study.trials)


def test_heartbeat_storage_still_gets_the_batch_thread(monkeypatch, tmp_path):
    spy = _Spy(monkeypatch)
    storage = optuna_tpu_torch.storages.RDBStorage(
        f"sqlite:///{tmp_path}/hb.db", heartbeat_interval=60, grace_period=120
    )
    study = optuna_tpu_torch.create_study(storage=storage, sampler=RandomSampler(seed=0))
    optimize_vectorized(study, _fast_objective(), n_trials=8, batch_size=4, device="cpu")
    assert spy.constructed == 2  # one shared thread a batch
    assert all(t.state == TrialState.COMPLETE for t in study.trials)


def test_clean_path_phase_count_matches_direct_dispatch():
    registry = telemetry.MetricsRegistry()
    telemetry.enable(registry)
    try:
        study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
        optimize_vectorized(study, _fast_objective(), n_trials=12, batch_size=4, device="cpu")
        phases = telemetry.phase_totals()
        for phase in ("ask", "dispatch", "tell"):
            assert phases[phase]["count"] == 3
        for family in ("executor.quarantine", "executor.bisection", "heartbeat.reap"):
            assert registry.counter_value(family) == 0
    finally:
        telemetry.disable()


def test_quarantine_is_counted_and_harvested_once_per_trial():
    from optuna_tpu_torch import device_stats
    from optuna_tpu_torch.testing.fault_injection import FaultyVectorizedObjective

    registry = telemetry.MetricsRegistry()
    telemetry.enable(registry)
    try:
        obj = FaultyVectorizedObjective(
            _quad, {"x": FloatDistribution(0.0, 1.0)}, nan_at={0: (1, 6)}, raise_at={1}
        )
        study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
        optimize_vectorized(study, obj, n_trials=16, batch_size=8, device="cpu")
        assert registry.counter_value("executor.quarantine") == 2
        assert registry.counter_value("executor.bisection") == 1
        assert device_stats.stat_gauges()["device.executor.quarantined.total"] == 2
    finally:
        telemetry.disable()


# ------------------------------------------- the executor's sampler faults


SAMPLER_SPACE = {"x": FloatDistribution(-1.0, 1.0), "y": FloatDistribution(0.0, 2.0)}


class _BatchRaisingSampler(RandomSampler):
    def sample_relative_batch(self, study, search_space, n):
        raise RuntimeError("batch fit crashed")


class _RelativeRaisingSampler(RandomSampler):
    def infer_relative_search_space(self, study, trial):
        return dict(SAMPLER_SPACE)

    def sample_relative(self, study, trial, search_space):
        raise RuntimeError("per-trial fit crashed")


def _vector_objective():
    return VectorizedObjective(lambda p: (p["x"] - 0.2) ** 2 + (p["y"] - 1.0) ** 2, dict(SAMPLER_SPACE))


def test_executor_batch_sampler_crash_degrades_to_independent():
    study = optuna_tpu_torch.create_study(sampler=_BatchRaisingSampler(seed=0))
    optimize_vectorized(study, _vector_objective(), n_trials=8, batch_size=4, device="cpu")
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    assert len(study.trials) == 8
    for t in study.trials:
        assert not non_finite_param_names(t.params)
        assert "batch fit crashed" in t.system_attrs[SAMPLER_FALLBACK_ATTR_PREFIX + "relative_batch"]


def test_executor_per_trial_sampler_crash_degrades_to_independent():
    study = optuna_tpu_torch.create_study(sampler=_RelativeRaisingSampler(seed=0))
    optimize_vectorized(study, _vector_objective(), n_trials=6, batch_size=3, device="cpu")
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    for t in study.trials:
        assert "per-trial fit crashed" in t.system_attrs[SAMPLER_FALLBACK_ATTR_PREFIX + "relative"]


def test_executor_fallback_raise_policy_surfaces_sampler_error():
    study = optuna_tpu_torch.create_study(sampler=_BatchRaisingSampler(seed=0))
    with pytest.raises(RuntimeError, match="batch fit crashed"):
        optimize_vectorized(study, _vector_objective(), n_trials=8, batch_size=4, fallback="raise", device="cpu")
    assert all(t.state != TrialState.RUNNING for t in study.trials)


class _CountingBatchRaisingSampler(RandomSampler):
    def __init__(self, seed=0):
        super().__init__(seed=seed)
        self.batch_calls = 0
        self.relative_calls = 0

    def infer_relative_search_space(self, study, trial):
        return dict(SAMPLER_SPACE)

    def sample_relative(self, study, trial, search_space):
        self.relative_calls += 1
        return {}

    def sample_relative_batch(self, study, search_space, n):
        self.batch_calls += 1
        raise RuntimeError("batch fit crashed")


def test_guarded_batch_crash_degrades_the_batch_once_not_per_trial():
    inner = _CountingBatchRaisingSampler(seed=0)
    study = optuna_tpu_torch.create_study(sampler=GuardedSampler(inner))
    optimize_vectorized(study, _vector_objective(), n_trials=8, batch_size=4, device="cpu")
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    assert inner.batch_calls == 2
    assert inner.relative_calls == 0
    for t in study.trials:
        assert "batch fit crashed" in t.system_attrs[SAMPLER_FALLBACK_ATTR_PREFIX + "relative_batch"]


def test_executor_inherits_guarded_study_raise_policy():
    study = optuna_tpu_torch.create_study(sampler=_BatchRaisingSampler(seed=0), sampler_fallback="raise")
    assert isinstance(study.sampler, GuardedSampler)
    with pytest.raises(RuntimeError, match="batch fit crashed"):
        optimize_vectorized(study, _vector_objective(), n_trials=8, batch_size=4, device="cpu")
    optimize_vectorized(study, _vector_objective(), n_trials=4, batch_size=4, fallback="independent", device="cpu")
    assert sum(t.state == TrialState.COMPLETE for t in study.trials) == 4


def test_executor_rejects_unknown_fallback_policy():
    from optuna_tpu_torch.parallel.executor import ResilientBatchExecutor

    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    with pytest.raises(ValueError, match="fallback must be one of"):
        ResilientBatchExecutor(study, _vector_objective(), fallback="shrug", device="cpu")


@pytest.mark.parametrize("where", ["batch", "per_trial"])
def test_a_device_fault_from_the_sampler_is_not_degraded(where):
    """A sampler's CUDA error is re-raised under ``fallback='independent'``
    (the port's one difference, as ``GuardedSampler``'s), and the batch's
    trials end FAIL."""
    error = RuntimeError("CUDA error: an illegal memory access was encountered")

    class Faulty(_RelativeRaisingSampler):
        def sample_relative(self, study, trial, search_space):
            raise error

        def sample_relative_batch(self, study, search_space, n):
            if where == "batch":
                raise error
            return None

    study = optuna_tpu_torch.create_study(sampler=Faulty(seed=0))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        optimize_vectorized(study, _vector_objective(), n_trials=4, batch_size=4, device="cpu")
    assert all(t.state == TrialState.FAIL for t in study.trials)
    assert not any(SAMPLER_FALLBACK_ATTR_PREFIX + "relative" in t.system_attrs for t in study.trials)
    assert len(study.trials) == (0 if where == "batch" else 4)  # a batch-hook fault strikes before any trial exists


# ------------------------------------------------- GPSampler through batches


@pytest.mark.parametrize("sparse", [False, True])
def test_gp_batches_are_one_chain_dispatch_each(monkeypatch, sparse):
    """Phase 31's path at a small size: GPSampler's batch hook answers each
    batch of 8 with one chain dispatch (above ``n_exact_max`` the sparse
    program, whose Matérn cross-covariance is K1's plain version here), and
    every trial completes inside the box."""
    from optuna_tpu_torch.models.benchmarks import hartmann6_np, hartmann6_torch
    from optuna_tpu_torch.gp import sparse as sparse_gp
    from optuna_tpu_torch.samplers import GPSampler

    space = {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(6)}
    kwargs = dict(n_exact_max=16, n_inducing=8) if sparse else {}
    sampler = GPSampler(seed=0, n_startup_trials=5, n_preliminary_samples=128, n_local_search=4, device="cpu", **kwargs)
    study = optuna_tpu_torch.create_study(sampler=sampler)
    X = np.random.default_rng(0).uniform(size=(24, 6))
    study.add_trials(
        optuna_tpu_torch.create_trial(params=dict(zip(space, map(float, row))), distributions=space, value=float(v))
        for row, v in zip(X, hartmann6_np(X))
    )
    chains, grams = [], []
    original_chain, original_gram = type(sampler)._sample_chain, sparse_gp.matern52_gram
    monkeypatch.setattr(type(sampler), "_sample_chain", lambda *a, **k: (chains.append(k.get("q")), original_chain(*a, **k))[1])
    monkeypatch.setattr(sparse_gp, "matern52_gram", lambda *a, **k: (grams.append(1), original_gram(*a, **k))[1])
    optimize_vectorized(study, VectorizedObjective(hartmann6_torch, space), n_trials=16, batch_size=8, device="cpu")
    assert chains == [8, 8]
    assert len(grams) == (2 if sparse else 0)  # K1 once a sparse batch, as phase 31 counts on the card
    new = study.trials[24:]
    assert len(new) == 16 and all(t.state == TrialState.COMPLETE for t in new)
    assert all(0.0 <= v <= 1.0 for t in new for v in t.params.values())
    assert len({tuple(t.params.values()) for t in new}) > 1
