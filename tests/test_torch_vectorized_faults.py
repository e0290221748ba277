"""Chaos suite for the port's resilient batch executor, on the CPU (the
cases of ``tests/test_vectorized_faults.py``, with ``device="cpu"``).

Each containment layer of ``optuna_tpu_torch/parallel/executor.py`` is
proved against injected faults: non-finite quarantine under ``fail``,
``raise`` and ``clip``; crash bisection salvaging B - 1 trials; OOM halving
under the ``RetryPolicy`` backoff and probationary regrowth; the dispatch
deadline, also around the host read that waits for the device; a killed
worker's batch reaped by a survivor and drained to the fault-free result;
``Study.stop()`` mid-batch. The heartbeat cases run on the port's RDB
storage over sqlite, as the reference's do, with the dead worker's beats
aged in the ``trial_heartbeats`` table.

Beyond the reference's cases: the port's out-of-memory error type
(``torch.OutOfMemoryError``) halves as the text rule does, and a device
fault (a CUDA error) FAILs its batch and re-raises with no bisection.
"""

from __future__ import annotations

import functools
import time
import warnings

import numpy as np
import pytest
import torch

import optuna_tpu_torch
from optuna_tpu_torch._callbacks import MaxTrialsCallback
from optuna_tpu_torch.distributions import FloatDistribution
from optuna_tpu_torch.parallel import (
    NON_FINITE_POLICIES,
    DispatchTimeoutError,
    NonFiniteObjectiveError,
    VectorizedObjective,
)
from optuna_tpu_torch.parallel import optimize_vectorized as _optimize_vectorized
from optuna_tpu_torch.samplers import RandomSampler, TPESampler
from optuna_tpu_torch.samplers._resilience import FALLBACK_POLICIES
from optuna_tpu_torch.storages import RetryFailedTrialCallback, RetryPolicy
from optuna_tpu_torch.storages._callbacks import EXECUTOR_ATTR_PREFIX
from optuna_tpu_torch.storages._heartbeat import fail_stale_trials
from optuna_tpu_torch.testing.fault_injection import (
    FALLBACK_CHAOS_POLICIES,
    NON_FINITE_CHAOS_POLICIES,
    FakeResourceExhaustedError,
    FaultyVectorizedObjective,
    SimulatedWorkerDeath,
)
from optuna_tpu_torch.trial._frozen import create_trial
from optuna_tpu_torch.trial._state import TrialState
from tests._torch_port import join_abandoned_dispatches, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "join_abandoned_dispatches")
optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.ERROR)

SPACE = {"x": FloatDistribution(0.0, 1.0)}
optimize_vectorized = functools.partial(_optimize_vectorized, device="cpu")


def _quad(params):
    return (params["x"] - 0.3) ** 2


def _states(study):
    return {state: sum(t.state == state for t in study.trials) for state in TrialState}


def test_chaos_matrices_cover_every_policy():
    assert set(NON_FINITE_CHAOS_POLICIES) == set(NON_FINITE_POLICIES)
    assert set(FALLBACK_CHAOS_POLICIES) == set(FALLBACK_POLICIES)


# ------------------------------------------------------ non-finite quarantine


def test_nan_quarantine_fails_poisoned_trials_only():
    obj = FaultyVectorizedObjective(_quad, SPACE, nan_at={0: (1, 4)})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(study, obj, n_trials=16, batch_size=8)

    counts = _states(study)
    assert counts[TrialState.COMPLETE] == 14
    assert counts[TrialState.FAIL] == 2
    assert counts[TrialState.RUNNING] == 0
    failed = [t for t in study.trials if t.state == TrialState.FAIL]
    assert sorted(t.number for t in failed) == [1, 4]
    assert all("non-finite" in t.system_attrs["fail_reason"] for t in failed)
    assert all(np.isfinite(t.value) for t in study.trials if t.state == TrialState.COMPLETE)
    assert np.isfinite(study.best_value)


def test_nan_quarantine_keeps_tpe_fit_finite_and_converging():
    obj = FaultyVectorizedObjective(_quad, SPACE, nan_at={0: (0, 3), 2: (5,)})
    study = optuna_tpu_torch.create_study(
        sampler=TPESampler(seed=7, n_startup_trials=8, constant_liar=True, device="cpu")
    )
    optimize_vectorized(study, obj, n_trials=48, batch_size=8)
    counts = _states(study)
    assert counts[TrialState.FAIL] == 3
    assert counts[TrialState.COMPLETE] == 45
    assert counts[TrialState.RUNNING] == 0
    assert np.isfinite(study.best_value)
    assert study.best_value < 0.05


def test_non_finite_raise_policy_quarantines_then_raises():
    obj = FaultyVectorizedObjective(_quad, SPACE, nan_at={0: (2,)})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=1))
    with pytest.raises(NonFiniteObjectiveError):
        optimize_vectorized(study, obj, n_trials=8, batch_size=8, non_finite="raise")
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.FAIL] == 1
    assert counts[TrialState.COMPLETE] == 7


def test_non_finite_clip_policy_completes_everything_finite():
    obj = FaultyVectorizedObjective(_quad, SPACE, nan_at={0: (2,)})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=1))
    optimize_vectorized(study, obj, n_trials=8, batch_size=8, non_finite="clip")
    trials = study.trials
    assert all(t.state == TrialState.COMPLETE for t in trials)
    assert all(np.isfinite(t.value) for t in trials)
    assert trials[2].value == 0.0  # nan_to_num on the device: NaN -> 0.0


@pytest.mark.parametrize("batch_size", [0, -4])
def test_non_positive_batch_size_is_rejected(batch_size):
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    with pytest.raises(ValueError, match="batch_size"):
        optimize_vectorized(study, VectorizedObjective(_quad, SPACE), n_trials=4, batch_size=batch_size)


def test_invalid_non_finite_policy_is_rejected():
    obj = VectorizedObjective(_quad, SPACE)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    with pytest.raises(ValueError, match="non_finite"):
        optimize_vectorized(study, obj, n_trials=8, non_finite="explode")


# --------------------------------------------------- crash containment paths


def test_poison_trial_bisection_salvages_the_rest():
    """Seed 5 draws exactly one x > 0.9 in the first batch; the persistent
    poison crashes every dispatch holding it, and bisection isolates it."""
    obj = FaultyVectorizedObjective(_quad, SPACE, raise_when=lambda host: bool((host["x"] > 0.9).any()))
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=5))
    optimize_vectorized(study, obj, n_trials=8, batch_size=8)

    trials = study.trials
    poison = [t for t in trials if t.params["x"] > 0.9]
    healthy = [t for t in trials if t.params["x"] <= 0.9]
    assert len(poison) == 1
    assert poison[0].state == TrialState.FAIL
    assert "dispatch raised" in poison[0].system_attrs["fail_reason"]
    assert all(t.state == TrialState.COMPLETE for t in healthy)
    assert obj.dispatches > 1
    assert _states(study)[TrialState.RUNNING] == 0


def test_transient_crash_bisection_salvages_everything():
    obj = FaultyVectorizedObjective(_quad, SPACE, raise_at={0})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=3))
    optimize_vectorized(study, obj, n_trials=8, batch_size=8)
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    assert obj.dispatch_widths == [8, 4, 4]


def test_systemic_dispatch_error_surfaces_instead_of_silent_all_fail():
    obj = FaultyVectorizedObjective(_quad, SPACE, raise_when=lambda _p: True)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=6))
    with pytest.raises(RuntimeError, match="injected dispatch crash"):
        optimize_vectorized(
            study, obj, n_trials=16, batch_size=8,
            retry_policy=RetryPolicy(max_attempts=3, sleep=lambda _s: None),
        )
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.FAIL] == 8


def test_crash_without_bisection_fails_whole_batch_and_raises():
    obj = FaultyVectorizedObjective(_quad, SPACE, raise_at={0})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=3))
    with pytest.raises(RuntimeError, match="injected dispatch crash"):
        optimize_vectorized(study, obj, n_trials=8, batch_size=8, bisect_on_error=False)
    counts = _states(study)
    assert counts[TrialState.FAIL] == 8
    assert counts[TrialState.RUNNING] == 0
    assert all("dispatch raised" in t.system_attrs["fail_reason"] for t in study.trials)


def test_oom_shaped_error_halves_batch_with_backoff_and_completes():
    sleeps: list[float] = []
    obj = FaultyVectorizedObjective(_quad, SPACE, oom_above=4)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=1))
    optimize_vectorized(study, obj, n_trials=16, batch_size=8, retry_policy=RetryPolicy(max_attempts=5, sleep=sleeps.append))
    assert obj.dispatch_widths == [8, 4, 4, 4, 4]
    assert len(sleeps) == 1
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    assert len(study.trials) == 16


def test_oom_cascade_reaches_floor_regardless_of_retry_budget():
    sleeps: list[float] = []
    obj = FaultyVectorizedObjective(_quad, SPACE, oom_above=2)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=4))
    optimize_vectorized(study, obj, n_trials=32, batch_size=32, retry_policy=RetryPolicy(max_attempts=2, sleep=sleeps.append))
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    assert len(study.trials) == 32
    assert min(obj.dispatch_widths) == 2
    assert obj.dispatch_widths[-1] == 2


def test_persistent_oom_at_floor_fails_batch_and_raises():
    obj = FaultyVectorizedObjective(_quad, SPACE, oom_above=0)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=2))
    with pytest.raises(Exception, match="RESOURCE_EXHAUSTED"):
        optimize_vectorized(
            study, obj, n_trials=8, batch_size=8, retry_policy=RetryPolicy(max_attempts=3, sleep=lambda _s: None)
        )
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.FAIL] >= 1


def _torch_oom_objective(limit: int, widths: list[int]):
    def fn(params):
        width = params["x"].shape[0]
        widths.append(width)
        if width > limit:
            raise torch.OutOfMemoryError(f"CUDA out of memory. Tried to allocate {width} GiB")
        return _quad(params)

    return fn


def test_torch_out_of_memory_error_halves_as_the_text_rule_does():
    """The card's OOM type takes the halving path (and regrowth), dispatch
    for dispatch as the fault kit's RESOURCE_EXHAUSTED stand-in does."""
    from optuna_tpu_torch.parallel.executor import _is_oom_error

    assert _is_oom_error(torch.OutOfMemoryError("allocator gave up"))  # by type: no telling text
    assert _is_oom_error(FakeResourceExhaustedError("RESOURCE_EXHAUSTED: injected"))
    assert not _is_oom_error(RuntimeError("CUDA error: an illegal memory access was encountered"))
    policy = dict(retry_policy=RetryPolicy(max_attempts=4, sleep=lambda _s: None))
    widths: list[int] = []
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(study, VectorizedObjective(_torch_oom_objective(8, widths), SPACE), 96, batch_size=32, **policy)
    fake = FaultyVectorizedObjective(_quad, SPACE, oom_above=8)
    twin = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(twin, fake, 96, batch_size=32, **policy)
    assert widths == fake.dispatch_widths
    assert widths[:4] == [32, 16, 8, 8]
    assert all(t.state == TrialState.COMPLETE for t in study.trials) and len(study.trials) == 96
    assert [t.params for t in study.trials] == [t.params for t in twin.trials]


@pytest.mark.parametrize("bisect", [True, False])
def test_device_fault_fails_the_batch_and_reraises_without_bisection(bisect):
    """A CUDA error other than OOM poisons the context: the batch's trials
    FAIL, the error re-raises at once, and no half is dispatched."""
    obj = FaultyVectorizedObjective(
        _quad, SPACE, raise_at={1},
        error_factory=lambda _i: RuntimeError("CUDA error: an illegal memory access was encountered"),
    )
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        optimize_vectorized(study, obj, n_trials=24, batch_size=8, bisect_on_error=bisect)
    assert obj.dispatch_widths == [8, 8]
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.COMPLETE] == 8 and counts[TrialState.FAIL] == 8
    failed = [t for t in study.trials if t.state == TrialState.FAIL]
    assert all("device fault" in t.system_attrs["fail_reason"] for t in failed)


def test_device_fault_after_an_oom_split_fails_the_halves_not_yet_run():
    """An OOM halves the batch; the first half then hits a device fault: the
    second half is FAILed without a dispatch on the poisoned context."""
    obj = FaultyVectorizedObjective(
        _quad, SPACE, oom_at={0}, raise_at={1},
        error_factory=lambda _i: RuntimeError("CUDA error: unspecified launch failure"),
    )
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    with pytest.raises(RuntimeError, match="launch failure"):
        optimize_vectorized(study, obj, 8, batch_size=8, retry_policy=RetryPolicy(sleep=lambda _s: None))
    assert obj.dispatch_widths == [8, 4]
    assert _states(study)[TrialState.FAIL] == 8


# ----------------------------------------------------------- dispatch deadline


def test_dispatch_deadline_converts_hang_into_fail_path():
    obj = FaultyVectorizedObjective(_quad, SPACE, hang_at={0}, hang_s=1.0)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=2))
    with pytest.raises(DispatchTimeoutError):
        optimize_vectorized(study, obj, n_trials=4, batch_size=4, bisect_on_error=False, dispatch_deadline_s=0.2)
    counts = _states(study)
    assert counts[TrialState.FAIL] == 4
    assert counts[TrialState.RUNNING] == 0


def test_persistent_hang_is_bounded_by_timeout_strike_budget():
    obj = FaultyVectorizedObjective(_quad, SPACE, hang_at=set(range(64)), hang_s=1.0)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=2))
    with pytest.raises(DispatchTimeoutError):
        optimize_vectorized(
            study, obj, n_trials=16, batch_size=8, dispatch_deadline_s=0.2,
            retry_policy=RetryPolicy(max_attempts=2, sleep=lambda _s: None),
        )
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.FAIL] == 8
    assert obj.dispatches <= 3


class _LazyHang(torch.Tensor):
    """A tensor whose first use blocks, as a read of a tensor from a hung
    card does: the objective's call returns at once, and the hang comes in
    the executor's stacking and host read."""

    hang_s = 0.0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        for a in args:
            if getattr(a, "hang_s", 0.0):
                hang_s, a.hang_s = a.hang_s, 0.0  # the first use waits, as a read would
                time.sleep(hang_s)
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


def _lazy(t: torch.Tensor, hang_s: float) -> _LazyHang:
    out = t.as_subclass(_LazyHang)
    out.hang_s = hang_s
    return out


def test_dispatch_deadline_covers_async_realization():
    class _AsyncHungObjective:
        search_space = SPACE

        def guarded(self, mesh, batch_axis, non_finite="fail"):
            def _fn(args):
                width = next(iter(args.values())).shape[0]
                return _lazy(torch.zeros(width), 2.5), torch.ones(width, dtype=torch.bool)

            return _fn

    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=5))
    start = time.monotonic()
    with pytest.raises(DispatchTimeoutError):
        optimize_vectorized(
            study, _AsyncHungObjective(), n_trials=4, batch_size=4, bisect_on_error=False, dispatch_deadline_s=0.2
        )
    assert time.monotonic() - start < 1.5  # bounded by the deadline, not by the 2.5 s hang
    counts = _states(study)
    assert counts[TrialState.FAIL] == 4
    assert counts[TrialState.RUNNING] == 0


def test_dispatch_deadline_with_bisection_salvages_after_transient_hang():
    obj = FaultyVectorizedObjective(_quad, SPACE, hang_at={0}, hang_s=1.0)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=2))
    optimize_vectorized(study, obj, n_trials=4, batch_size=4, dispatch_deadline_s=0.2)
    assert all(t.state == TrialState.COMPLETE for t in study.trials)


# ------------------------------------------------------- stop() mid-batch


def test_stop_mid_batch_does_not_overshoot_budget():
    obj = VectorizedObjective(_quad, SPACE)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(study, obj, n_trials=24, batch_size=8, callbacks=[MaxTrialsCallback(3)])
    counts = _states(study)
    assert counts[TrialState.COMPLETE] == 3
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.FAIL] == 5
    assert len(study.trials) == 8
    stopped = [t for t in study.trials if t.state == TrialState.FAIL]
    assert all("stopped" in t.system_attrs["fail_reason"] for t in stopped)


def test_stop_from_quarantine_callback_does_not_swallow_raise_policy():
    obj = FaultyVectorizedObjective(_quad, SPACE, nan_at={0: (0,)})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))

    def stop_on_fail(s, frozen):
        if frozen.state == TrialState.FAIL:
            s.stop()

    with pytest.raises(NonFiniteObjectiveError):
        optimize_vectorized(study, obj, n_trials=8, batch_size=8, non_finite="raise", callbacks=[stop_on_fail])
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.FAIL] == 8


def test_callbacks_fire_exactly_once_for_every_terminal_path():
    seen: list[tuple[int, TrialState]] = []
    obj = FaultyVectorizedObjective(
        _quad, SPACE, nan_at={2: (0,)}, raise_when=lambda host: bool((host["x"] > 0.9).any())
    )
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=5))
    optimize_vectorized(
        study, obj, n_trials=8, batch_size=8, callbacks=[lambda _s, frozen: seen.append((frozen.number, frozen.state))]
    )
    assert sorted(number for number, _ in seen) == list(range(8))
    by_number = dict(seen)
    assert by_number[0] == TrialState.FAIL
    assert sum(state == TrialState.FAIL for state in by_number.values()) == 2
    assert sum(state == TrialState.COMPLETE for state in by_number.values()) == 6


def test_value_conversion_fail_still_notifies_callbacks():
    seen: list[TrialState] = []
    study = optuna_tpu_torch.create_study(directions=["minimize", "minimize"], sampler=RandomSampler(seed=0))

    def _wrong_arity(params):
        v = (params["x"] - 0.3) ** 2
        return torch.stack([v, v, v], dim=-1)

    obj = VectorizedObjective(_wrong_arity, SPACE)
    with pytest.warns(UserWarning, match="did not match the number of the objectives"):
        optimize_vectorized(
            study, obj, n_trials=4, batch_size=4, callbacks=[lambda _s, frozen: seen.append(frozen.state)]
        )
    counts = _states(study)
    assert counts[TrialState.FAIL] == 4
    assert counts[TrialState.RUNNING] == 0
    assert seen == [TrialState.FAIL] * 4


def test_width_dependent_hang_exhausts_timeout_budget():
    obj = FaultyVectorizedObjective(_quad, SPACE, hang_at={0, 3}, hang_s=1.5)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=3))
    with pytest.raises(DispatchTimeoutError):
        optimize_vectorized(
            study, obj, n_trials=24, batch_size=8, dispatch_deadline_s=0.5,
            retry_policy=RetryPolicy(max_attempts=2, sleep=lambda _s: None),
        )
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.COMPLETE] == 8
    assert counts[TrialState.FAIL] == 8
    assert obj.dispatches == 4


def test_sub_dispatch_oom_resets_regrowth_streak():
    obj = FaultyVectorizedObjective(_quad, SPACE, oom_at={0, 4}, raise_at={3})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=8))
    optimize_vectorized(
        study, obj, n_trials=28, batch_size=8, retry_policy=RetryPolicy(max_attempts=5, sleep=lambda _s: None)
    )
    assert obj.dispatch_widths == [8, 4, 4, 4, 2, 1, 1, 2, 4, 4, 8]
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    assert len(study.trials) == 28


def test_min_retry_budget_still_salvages_isolated_poison_trial():
    obj = FaultyVectorizedObjective(_quad, SPACE, raise_when=lambda host: bool((host["x"] > 0.9).any()))
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=5))
    optimize_vectorized(
        study, obj, n_trials=8, batch_size=8, retry_policy=RetryPolicy(max_attempts=1, sleep=lambda _s: None)
    )
    counts = _states(study)
    assert counts[TrialState.COMPLETE] == 7
    assert counts[TrialState.FAIL] == 1
    assert counts[TrialState.RUNNING] == 0


def test_transient_oom_clamp_grows_back_after_clean_batches():
    obj = FaultyVectorizedObjective(_quad, SPACE, oom_at={0})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=6))
    optimize_vectorized(
        study, obj, n_trials=40, batch_size=8, retry_policy=RetryPolicy(max_attempts=4, sleep=lambda _s: None)
    )
    assert obj.dispatch_widths == [8, 4, 4, 4, 4, 8, 8, 8]
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    assert len(study.trials) == 40


def test_sub_dispatch_oom_does_not_clamp_study_batch_size():
    obj = FaultyVectorizedObjective(_quad, SPACE, raise_at={0}, oom_at={1})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(
        study, obj, n_trials=24, batch_size=8, retry_policy=RetryPolicy(max_attempts=4, sleep=lambda _s: None)
    )
    assert obj.dispatch_widths == [8, 4, 2, 2, 4, 8, 8]
    assert all(t.state == TrialState.COMPLETE for t in study.trials)
    assert len(study.trials) == 24


def test_oom_shaped_poison_error_is_salvaged_not_fatal():
    obj = FaultyVectorizedObjective(
        _quad, SPACE,
        raise_when=lambda host: bool((host["x"] > 0.9).any()),
        error_factory=lambda _i: RuntimeError("ran out of memory in user preprocessing"),
    )
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=5))
    optimize_vectorized(
        study, obj, n_trials=8, batch_size=8, retry_policy=RetryPolicy(max_attempts=4, sleep=lambda _s: None)
    )
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.FAIL] == 1
    assert counts[TrialState.COMPLETE] == 7
    failed = [t for t in study.trials if t.state == TrialState.FAIL]
    assert all(t.params["x"] > 0.9 for t in failed)


def _ask_suggested(study, n):
    trials = study.ask_batch(n)
    for trial in trials:
        for name, dist in SPACE.items():
            trial._suggest(name, dist)
    return trials


def test_reaped_trial_is_not_double_notified(monkeypatch):
    from optuna_tpu_torch.parallel.executor import ResilientBatchExecutor

    seen: list[int] = []
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    ex = ResilientBatchExecutor(
        study, VectorizedObjective(_quad, SPACE), callbacks=[lambda _s, frozen: seen.append(frozen.number)],
        device="cpu",
    )

    # COMPLETE path: trial 0 was reaped to FAIL mid-dispatch.
    trials = _ask_suggested(study, 2)
    study.tell(trials[0], state=TrialState.FAIL)
    ex._tell_batch(trials, np.array([0.5, 0.25]), np.array([True, True]))
    assert study.trials[0].state == TrialState.FAIL
    assert study.trials[1].state == TrialState.COMPLETE
    assert seen == [1]

    # FAIL path, race before the attr write.
    seen.clear()
    (reaped,) = _ask_suggested(study, 1)
    study.tell(reaped, 0.1)
    ex._fail_trials([reaped], "batch dispatch raised: boom")
    assert study.trials[reaped.number].state == TrialState.COMPLETE
    assert seen == []

    # FAIL path, race between the attr write and the tell.
    seen.clear()
    (racy,) = _ask_suggested(study, 1)
    storage = study._storage
    original = storage.set_trial_system_attr

    def reap_after_attr_write(trial_id, key, value):
        original(trial_id, key, value)
        if key == "fail_reason" and trial_id == racy._trial_id:
            storage.set_trial_state_values(trial_id, state=TrialState.FAIL)

    monkeypatch.setattr(storage, "set_trial_system_attr", reap_after_attr_write)
    ex._fail_trials([racy], "batch dispatch raised: boom")
    assert study.trials[racy.number].state == TrialState.FAIL
    assert seen == []

    # COMPLETE path, race during the tell (after its pre-read, before its
    # commit): only that trial is skipped.
    monkeypatch.undo()
    seen.clear()
    trials = _ask_suggested(study, 2)
    target_id = trials[0]._trial_id
    original_set_state = storage.set_trial_state_values
    reaped_mid_tell = []

    def reap_mid_tell(trial_id, state, values=None):
        if trial_id == target_id and state == TrialState.COMPLETE and not reaped_mid_tell:
            reaped_mid_tell.append(trial_id)
            original_set_state(trial_id, state=TrialState.FAIL)
        return original_set_state(trial_id, state=state, values=values)

    monkeypatch.setattr(storage, "set_trial_state_values", reap_mid_tell)
    ex._tell_batch(trials, np.array([0.5, 0.25]), np.array([True, True]))
    assert reaped_mid_tell
    assert study.trials[trials[0].number].state == TrialState.FAIL
    assert study.trials[trials[1].number].state == TrialState.COMPLETE
    assert seen == [trials[1].number]


def test_batch_setup_error_fails_created_trials_before_raising():
    class ExplodingSampler(RandomSampler):
        def __init__(self):
            super().__init__(seed=0)
            self.calls = 0

        def sample_independent(self, study, trial, name, dist):
            self.calls += 1
            if self.calls == 3:
                raise RuntimeError("sampler exploded mid-batch")
            return super().sample_independent(study, trial, name, dist)

    study = optuna_tpu_torch.create_study(sampler=ExplodingSampler())
    with pytest.raises(RuntimeError, match="sampler exploded"):
        optimize_vectorized(study, VectorizedObjective(_quad, SPACE), n_trials=8, batch_size=8)
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.FAIL] == 8
    assert all("batch aborted" in t.system_attrs["fail_reason"] for t in study.trials)


def test_storage_blip_during_fail_tells_does_not_strand_rest_of_batch(monkeypatch):
    obj = FaultyVectorizedObjective(_quad, SPACE, raise_at={0})
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    storage = study._storage
    original = storage.set_trial_state_values
    blipped: list[int] = []

    def blippy(trial_id, state, values=None):
        if state == TrialState.FAIL and not blipped:
            blipped.append(trial_id)
            raise RuntimeError("transient storage blip")
        return original(trial_id, state=state, values=values)

    monkeypatch.setattr(storage, "set_trial_state_values", blippy)
    with pytest.raises(RuntimeError, match="transient storage blip"):
        optimize_vectorized(study, obj, n_trials=8, batch_size=8, bisect_on_error=False)
    counts = _states(study)
    assert blipped
    assert counts[TrialState.FAIL] == 8
    assert counts[TrialState.RUNNING] == 0


def test_callback_error_mid_batch_fails_untold_remainder():
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))

    def bomb(_study, frozen):
        if frozen.number == 2:
            raise RuntimeError("callback exploded")

    with pytest.raises(RuntimeError, match="callback exploded"):
        optimize_vectorized(study, VectorizedObjective(_quad, SPACE), n_trials=8, batch_size=8, callbacks=[bomb])
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.COMPLETE] == 3
    assert counts[TrialState.FAIL] == 5
    failed = [t for t in study.trials if t.state == TrialState.FAIL]
    assert all("batch aborted" in t.system_attrs["fail_reason"] for t in failed)


def test_fail_reason_blip_does_not_skip_fail_tell(monkeypatch):
    from optuna_tpu_torch.parallel.executor import ResilientBatchExecutor

    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    ex = ResilientBatchExecutor(study, VectorizedObjective(_quad, SPACE), device="cpu")
    trials = _ask_suggested(study, 2)
    storage = study._storage
    original = storage.set_trial_system_attr

    def blip_first(trial_id, key, value):
        if trial_id == trials[0]._trial_id and key == "fail_reason":
            raise ConnectionError("transient attr-write blip")
        return original(trial_id, key, value)

    monkeypatch.setattr(storage, "set_trial_system_attr", blip_first)
    ex._fail_trials(trials, "batch dispatch raised: boom")
    counts = _states(study)
    assert counts[TrialState.FAIL] == 2
    assert counts[TrialState.RUNNING] == 0


def test_persistently_raising_callback_cannot_strand_trials_running():
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))

    def always_bomb(_study, _frozen):
        raise RuntimeError("callback always explodes")

    with pytest.raises(RuntimeError, match="callback always explodes"):
        optimize_vectorized(study, VectorizedObjective(_quad, SPACE), n_trials=8, batch_size=8, callbacks=[always_bomb])
    counts = _states(study)
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.COMPLETE] == 1
    assert counts[TrialState.FAIL] == 7


def test_nested_invocation_from_callback_is_rejected():
    obj = VectorizedObjective(_quad, SPACE)
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    errors: list[RuntimeError] = []

    def nested(inner_study, _frozen):
        try:
            optimize_vectorized(inner_study, obj, n_trials=4, batch_size=4)
        except RuntimeError as err:
            errors.append(err)

    optimize_vectorized(study, obj, n_trials=4, batch_size=4, callbacks=[nested])
    assert len(errors) == 4
    assert all("Nested invocation" in str(err) for err in errors)
    assert len(study.trials) == 4


# ------------------------------------------- retry-clone system-attr hygiene


def test_retry_callback_strips_executor_attrs_but_keeps_lineage():
    study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    failed = create_trial(
        state=TrialState.FAIL,
        params={"x": 0.5},
        distributions={"x": FloatDistribution(0.0, 1.0)},
        system_attrs={
            EXECUTOR_ATTR_PREFIX + "dispatch": {"batch": "dead/0", "slot": 3},
            "fail_reason": "batch dispatch raised: RuntimeError('boom')",
            "retry_history": [],
        },
    )
    study.add_trial(failed)
    RetryFailedTrialCallback()(study, study.trials[0])

    clone = study.trials[1]
    assert clone.state == TrialState.WAITING
    assert not any(k.startswith(EXECUTOR_ATTR_PREFIX) for k in clone.system_attrs)
    assert "fail_reason" not in clone.system_attrs
    assert clone.system_attrs["failed_trial"] == 0
    assert clone.system_attrs["retry_history"] == [0]
    assert clone.system_attrs["fixed_params"] == {"x": 0.5}


def test_executor_writes_prefixed_dispatch_bookkeeping(tmp_path):
    storage = optuna_tpu_torch.storages.RDBStorage(
        f"sqlite:///{tmp_path}/hb.db", heartbeat_interval=60, grace_period=120
    )
    study = optuna_tpu_torch.create_study(storage=storage, sampler=RandomSampler(seed=0))
    optimize_vectorized(study, VectorizedObjective(_quad, SPACE), n_trials=8, batch_size=4)
    for trial in study.trials:
        record = trial.system_attrs[EXECUTOR_ATTR_PREFIX + "dispatch"]
        assert 0 <= record["slot"] < 4
        assert "/" in record["batch"]
    beats = storage._conn().execute("SELECT trial_id FROM trial_heartbeats").fetchall()
    assert {row[0] for row in beats} == {t._trial_id for t in study.trials}
    tags = {t.system_attrs[EXECUTOR_ATTR_PREFIX + "dispatch"]["batch"] for t in study.trials}
    assert len(tags) == 2

    plain = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
    optimize_vectorized(plain, VectorizedObjective(_quad, SPACE), n_trials=4, batch_size=4)
    assert not any(k.startswith(EXECUTOR_ATTR_PREFIX) for t in plain.trials for k in t.system_attrs)


# -------------------------------------------------- the acceptance scenario


def test_chaos_study_with_kill_reap_and_drain_converges_exactly(tmp_path):
    """NaN trials, one mid-batch crash and one worker death in one study.
    After a survivor's reap and a drain over the enqueued clones: nothing
    RUNNING, every healthy trial COMPLETE once, the best value the
    fault-free run's."""
    clean = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=9))
    optimize_vectorized(clean, VectorizedObjective(_quad, SPACE), n_trials=24, batch_size=8)
    clean_values = sorted(t.value for t in clean.trials)

    storage = optuna_tpu_torch.storages.RDBStorage(
        f"sqlite:///{tmp_path}/vchaos.db", heartbeat_interval=60, grace_period=120,
        failed_trial_callback=RetryFailedTrialCallback(max_retry=2),
    )
    study = optuna_tpu_torch.create_study(study_name="vchaos", storage=storage, sampler=RandomSampler(seed=9))
    # batch 0 = dispatch 0 (NaN at slot 2); batch 1 = dispatch 1 (transient
    # crash; halves 2 and 3); batch 2 = dispatch 4 (worker death).
    obj = FaultyVectorizedObjective(_quad, SPACE, nan_at={0: (2,)}, raise_at={1}, kill_at={4})
    with pytest.raises(SimulatedWorkerDeath):
        optimize_vectorized(study, obj, n_trials=24, batch_size=8)
    assert _states(study)[TrialState.RUNNING] == 8

    # The dead worker's beats age past the grace period; a survivor reaps.
    con = storage._conn()
    con.execute("UPDATE trial_heartbeats SET heartbeat = heartbeat - 100000")
    survivor = optuna_tpu_torch.load_study(study_name="vchaos", storage=storage)
    survivor.sampler = RandomSampler(seed=99)  # irrelevant: clones fix params
    fail_stale_trials(survivor)

    reaped = survivor.trials
    clones = [t for t in reaped if t.state == TrialState.WAITING]
    assert len(clones) == 8
    assert sum(t.state == TrialState.RUNNING for t in reaped) == 0
    assert not any(k.startswith(EXECUTOR_ATTR_PREFIX) for c in clones for k in c.system_attrs)
    assert all("fixed_params" in c.system_attrs for c in clones)

    retry = RetryFailedTrialCallback()
    for t in reaped:
        if t.state == TrialState.FAIL and "non-finite" in t.system_attrs.get("fail_reason", ""):
            retry(survivor, t)

    waiting = [t for t in survivor.trials if t.state == TrialState.WAITING]
    assert len(waiting) == 9
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        optimize_vectorized(survivor, VectorizedObjective(_quad, SPACE), n_trials=len(waiting), batch_size=8)

    final = survivor.trials
    counts = {s: sum(t.state == s for t in final) for s in TrialState}
    assert counts[TrialState.RUNNING] == 0
    assert counts[TrialState.COMPLETE] == 24
    final_values = sorted(t.value for t in final if t.state == TrialState.COMPLETE)
    assert final_values == clean_values
    assert survivor.best_value == clean.best_value
