"""Importable sampler behavioral suites (port of
``optuna_tpu/testing/pytest_samplers.py``).

Parity target: ``optuna/testing/pytest_samplers.py:99-442`` — shipped
sampler-agnostic contract classes any ``BaseSampler`` author can run against
their implementation. Subclass the capability classes that apply and provide
the fixture each one documents:

    from optuna_tpu_torch.testing.pytest_samplers import BasicSamplerTestCase

    class TestMySampler(BasicSamplerTestCase):
        @pytest.fixture
        def sampler_factory(self):
            return lambda **kw: MySampler(seed=kw.get("seed", 0))

``sampler_factory`` must return a FRESH sampler per call and honor a ``seed``
keyword; a sampler that takes a ``device`` samples where it says (pass
``device="cpu"`` on a machine without a card). The in-repo matrix run lives
in ``tests/test_torch_sampler_contract.py``.
"""

from __future__ import annotations

import pytest

import optuna_tpu_torch
from optuna_tpu_torch import TrialState, create_study
from optuna_tpu_torch.distributions import FloatDistribution, IntDistribution
from optuna_tpu_torch.trial import Trial

FLOAT_DISTS = [
    FloatDistribution(-5.0, 5.0),
    FloatDistribution(1e-5, 1e5, log=True),
    FloatDistribution(-2.0, 2.0, step=0.5),
    FloatDistribution(0.0, 0.0),  # single-point
]
INT_DISTS = [
    IntDistribution(-7, 7),
    IntDistribution(1, 1024, log=True),
    IntDistribution(0, 12, step=3),
    IntDistribution(4, 4),  # single-point
]
CAT_CHOICES = [
    ("a", "b", "c"),
    (1, 2.5, None),
    (True, False),
    (0.0,),  # single choice
]


class _SamplerTestCase:
    @pytest.fixture
    def sampler_factory(self):
        raise NotImplementedError("provide a `sampler_factory` fixture")


class BasicSamplerTestCase(_SamplerTestCase):
    """Domain correctness, dynamic/conditional spaces, failure resilience —
    the contract every general-purpose sampler must satisfy."""

    @pytest.mark.parametrize("dist", FLOAT_DISTS, ids=["plain", "log", "step", "single"])
    def test_float_domain(self, sampler_factory, dist):
        def objective(trial: Trial) -> float:
            v = trial.suggest_float("x", dist.low, dist.high, log=dist.log, step=dist.step)
            assert isinstance(v, float)
            assert dist.low <= v <= dist.high
            if dist.step is not None:
                k = (v - dist.low) / dist.step
                assert abs(k - round(k)) < 1e-9
            return v

        study = create_study(sampler=sampler_factory())
        study.optimize(objective, n_trials=8)
        assert all(t.state == TrialState.COMPLETE for t in study.trials)

    @pytest.mark.parametrize("dist", INT_DISTS, ids=["plain", "log", "step", "single"])
    def test_int_domain(self, sampler_factory, dist):
        def objective(trial: Trial) -> float:
            v = trial.suggest_int("i", dist.low, dist.high, log=dist.log, step=dist.step)
            assert isinstance(v, int) and not isinstance(v, bool)
            assert dist.low <= v <= dist.high
            assert (v - dist.low) % dist.step == 0
            return float(v)

        study = create_study(sampler=sampler_factory())
        study.optimize(objective, n_trials=8)
        assert all(t.state == TrialState.COMPLETE for t in study.trials)

    @pytest.mark.parametrize("choices", CAT_CHOICES, ids=["str", "mixed", "bool", "single"])
    def test_categorical_domain(self, sampler_factory, choices):
        def objective(trial: Trial) -> float:
            v = trial.suggest_categorical("c", choices)
            assert any(v is c or v == c for c in choices)
            return float(choices.index(v))

        study = create_study(sampler=sampler_factory())
        study.optimize(objective, n_trials=8)
        seen = {t.params["c"] for t in study.trials}
        assert seen <= set(choices)

    def test_dynamic_value_range(self, sampler_factory):
        """The same param name with a per-trial range must never escape the
        trial's own range (reference BasicSamplerTestCase.test_dynamic_range)."""

        def objective(trial: Trial) -> float:
            width = 1.0 + (trial.number % 3)
            x = trial.suggest_float("x", -width, width)
            assert -width <= x <= width
            i = trial.suggest_int("i", 0, trial.number % 4 + 1)
            assert 0 <= i <= trial.number % 4 + 1
            return x + i

        study = create_study(sampler=sampler_factory())
        study.optimize(objective, n_trials=10)
        assert len(study.trials) == 10

    def test_deep_conditional_tree(self, sampler_factory):
        def objective(trial: Trial) -> float:
            algo = trial.suggest_categorical("algo", ["svm", "forest"])
            if algo == "svm":
                kernel = trial.suggest_categorical("kernel", ["rbf", "poly"])
                c = trial.suggest_float("C", 1e-3, 1e3, log=True)
                if kernel == "poly":
                    degree = trial.suggest_int("degree", 2, 5)
                    return c * degree
                return c
            depth = trial.suggest_int("depth", 1, 16, log=True)
            est = trial.suggest_int("n_estimators", 10, 100, step=10)
            return depth + est / 100.0

        study = create_study(sampler=sampler_factory())
        study.optimize(objective, n_trials=14)
        for t in study.trials:
            if t.params["algo"] == "svm":
                assert "depth" not in t.params
                assert ("degree" in t.params) == (t.params["kernel"] == "poly")
            else:
                assert "kernel" not in t.params and "C" not in t.params

    def test_survives_failed_and_pruned_history(self, sampler_factory):
        def objective(trial: Trial) -> float:
            x = trial.suggest_float("x", 0.0, 1.0)
            if trial.number % 4 == 1:
                raise optuna_tpu_torch.TrialPruned()
            if trial.number % 4 == 2:
                raise RuntimeError("boom")
            return x

        study = create_study(sampler=sampler_factory())
        study.optimize(objective, n_trials=16, catch=(RuntimeError,))
        states = [t.state for t in study.trials]
        assert states.count(TrialState.PRUNED) == 4
        assert states.count(TrialState.FAIL) == 4
        assert states.count(TrialState.COMPLETE) == 8

    def test_nan_objective_value_ignored_for_best(self, sampler_factory):
        """NaN completions must not poison best_value (reference
        ``pytest_samplers.py:209-227``)."""
        study = create_study(sampler=sampler_factory())

        def objective(trial: Trial, base: float) -> float:
            return trial.suggest_float("x", 0.1, 0.2) + base

        for i in range(6, 1, -1):
            study.optimize(lambda t, i=i: objective(t, i), n_trials=1)
        assert int(study.best_value) == 2
        study.optimize(lambda t: objective(t, float("nan")), n_trials=1)
        assert int(study.best_value) == 2
        study.optimize(lambda t: objective(t, 1.0), n_trials=1)
        assert int(study.best_value) == 1

    def test_partial_fixed_wrapper_pins_param(self, sampler_factory):
        """Every sampler must compose with PartialFixedSampler (reference
        ``pytest_samplers.py:228-248``)."""
        from optuna_tpu_torch.samplers import PartialFixedSampler

        def objective(trial: Trial) -> float:
            x = trial.suggest_float("x", -1, 1)
            y = trial.suggest_int("y", -1, 1)
            z = trial.suggest_float("z", -1, 1)
            return x + y + z

        study = create_study(sampler=sampler_factory())
        study.optimize(objective, n_trials=1)
        study.sampler = PartialFixedSampler({"y": 0}, study.sampler)
        study.optimize(objective, n_trials=1)
        assert study.trials[-1].params["y"] == 0

    def test_sample_single_point_relative_space(self, sampler_factory):
        """Degenerate (single-point) distributions across every flavour must
        sample their only value, including once a model can be fit
        (reference ``pytest_samplers.py:249-271``)."""
        from optuna_tpu_torch.distributions import CategoricalDistribution

        space = {
            "a": CategoricalDistribution([1]),
            "b": IntDistribution(low=1, high=1),
            "c": IntDistribution(low=1, high=1, log=True),
            "d": FloatDistribution(low=1.0, high=1.0),
            "e": FloatDistribution(low=1.0, high=1.0, log=True),
            "f": FloatDistribution(low=1.0, high=1.0, step=1.0),
        }
        study = create_study(sampler=sampler_factory())
        for _ in range(2):
            trial = study.ask(fixed_distributions=space)
            study.tell(trial, 1.0)
            for name in space:
                assert trial.params[name] == 1

    def test_combination_objective_completes(self, sampler_factory):
        """A space mixing every distribution flavour in one objective
        (reference ``pytest_samplers.py:307-330``)."""

        def objective(trial: Trial) -> float:
            x = trial.suggest_float("x", -1.0, 1.0)
            y = trial.suggest_float("y", 1e-3, 1.0, log=True)
            z = trial.suggest_float("z", -1.0, 1.0, step=0.25)
            i = trial.suggest_int("i", 0, 8)
            j = trial.suggest_int("j", 1, 128, log=True)
            c = trial.suggest_categorical("c", ("a", "b", "c"))
            return x + y + z + i + j + (1.0 if c == "a" else 0.0)

        study = create_study(sampler=sampler_factory())
        study.optimize(objective, n_trials=12)
        assert len(study.trials) == 12
        assert all(t.state == TrialState.COMPLETE for t in study.trials)


class SeededSamplerTestCase(_SamplerTestCase):
    """Determinism contract for samplers accepting a seed."""

    def test_same_seed_reproduces_sequence(self, sampler_factory):
        def objective(trial: Trial) -> float:
            x = trial.suggest_float("x", -1.0, 1.0)
            i = trial.suggest_int("i", 0, 9)
            return x + i

        runs = []
        for _ in range(2):
            study = create_study(sampler=sampler_factory(seed=42))
            study.optimize(objective, n_trials=10)
            runs.append([(t.params["x"], t.params["i"]) for t in study.trials])
        assert runs[0] == runs[1]

    def test_reseed_rng_changes_stream(self, sampler_factory):
        sampler = sampler_factory(seed=7)
        study1 = create_study(sampler=sampler)
        study1.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=6)
        sampler2 = sampler_factory(seed=7)
        sampler2.reseed_rng()
        study2 = create_study(sampler=sampler2)
        study2.optimize(lambda t: t.suggest_float("x", 0, 1), n_trials=6)
        a = [t.params["x"] for t in study1.trials]
        b = [t.params["x"] for t in study2.trials]
        # Independent-phase draws must diverge after an explicit reseed.
        assert a != b


class RelativeSamplerTestCase(_SamplerTestCase):
    """The two-phase relative-sampling protocol (reference
    ``optuna/samplers/_base.py:36-58``)."""

    def test_relative_params_within_distribution(self, sampler_factory):
        sampler = sampler_factory()
        study = create_study(sampler=sampler)

        def objective(trial: Trial) -> float:
            x = trial.suggest_float("x", -3.0, 3.0)
            i = trial.suggest_int("i", 0, 10)
            return x * x + i

        study.optimize(objective, n_trials=6)
        frozen = study.trials[-1]
        space = sampler.infer_relative_search_space(study, frozen)
        for pname in space:
            assert pname in ("x", "i")
        t = study.ask()
        proposal = sampler.sample_relative(study, t._cached_frozen_trial, space)
        for pname, value in proposal.items():
            assert space[pname]._contains(space[pname].to_internal_repr(value))
        study.tell(t, 1.0)

    def test_relative_space_excludes_conditional_params(self, sampler_factory):
        sampler = sampler_factory()
        study = create_study(sampler=sampler)

        def objective(trial: Trial) -> float:
            x = trial.suggest_float("x", 0.0, 1.0)
            if trial.number % 2:
                y = trial.suggest_float("y", 0.0, 1.0)
                return x + y
            return x

        study.optimize(objective, n_trials=8)
        space = sampler.infer_relative_search_space(study, study.trials[-1])
        # y is not in every trial -> the intersection space is {x} only.
        assert set(space) <= {"x"}


class MultiObjectiveSamplerTestCase(_SamplerTestCase):
    def test_multi_objective_study_runs(self, sampler_factory):
        def objective(trial: Trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            y = trial.suggest_float("y", 0.0, 1.0)
            return x, (1.0 - x) * (1.0 + y)

        study = create_study(directions=["minimize", "minimize"], sampler=sampler_factory())
        study.optimize(objective, n_trials=12)
        assert len(study.trials) == 12
        assert len(study.best_trials) >= 1
        for t in study.best_trials:
            assert len(t.values) == 2


class ConstrainedSamplerTestCase:
    """Constraint storage protocol: subclass must provide a
    ``constrained_factory`` fixture taking a constraints_func."""

    @pytest.fixture
    def constrained_factory(self):
        raise NotImplementedError("provide a `constrained_factory` fixture")

    def test_constraints_steer_best_trial(self, constrained_factory):
        def constraints(frozen):
            # Feasible iff x <= 0.5 (constraint value <= 0).
            return (frozen.params["x"] - 0.5,)

        sampler = constrained_factory(constraints)
        study = create_study(sampler=sampler)
        study.optimize(lambda t: t.suggest_float("x", 0.0, 1.0), n_trials=14)
        from optuna_tpu_torch.samplers._base import _CONSTRAINTS_KEY

        stored = [t.system_attrs.get(_CONSTRAINTS_KEY) for t in study.trials]
        assert all(s is not None for s in stored)
        assert all(len(s) == 1 for s in stored)
