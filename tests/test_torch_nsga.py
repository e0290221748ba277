"""NSGA-II studies of the port against the reference, on the CPU.

Both packages draw every random number from host numpy and dominance is
exact, so a study must be identical trial for trial: params, values,
states, trial system attrs (generations, constraints) and the parent
populations cached in the study's system attrs. That holds on both rank
routes of the port: the host sort, and the device branch (the dominance
kernel's plain version on the CPU), reached here by lowering
``_DEVICE_RANK_MIN_POINTS`` to 16 (8 for the constrained study, whose
pools hold fewer feasible points).
"""

from __future__ import annotations

import numpy as np
import pytest

import optuna_tpu
import optuna_tpu_torch
import optuna_tpu.samplers.nsgaii as ref_nsgaii
import optuna_tpu_torch.ops.pareto as port_pareto
import optuna_tpu_torch.samplers.nsgaii as port_nsgaii
from optuna_tpu.models.benchmarks import zdt1 as ref_zdt1
from optuna_tpu_torch.models import benchmarks
from optuna_tpu_torch.study import _multi_objective

POPULATION = 8
GENERATIONS = 5
DIM = 6


def _summary(study):
    trials = [
        (t.number, t.state.name, t.params, t.values, t.system_attrs)
        for t in study.get_trials(deepcopy=False)
    ]
    return trials, study._storage.get_study_system_attrs(study._study_id)


def _constraints(trial):
    return [trial.params["x1"] - 0.8, 0.1 - trial.params["x0"]]


def _operators(pkg, name):
    nsgaii = ref_nsgaii if pkg is optuna_tpu else port_nsgaii
    if name == "sbx+polynomial":
        return {"crossover": nsgaii.SBXCrossover(), "mutation": nsgaii.PolynomialMutation()}
    if name == "blx":
        return {"crossover": nsgaii.BLXAlphaCrossover()}
    return {}


def _run(pkg, objective, *, constrained, operators, **port_kwargs):
    pkg.logging.set_verbosity(pkg.logging.WARNING)
    kwargs = dict(seed=0, population_size=POPULATION, **_operators(pkg, operators), **port_kwargs)
    if constrained:
        kwargs["constraints_func"] = _constraints
    sampler = pkg.samplers.NSGAIISampler(**kwargs)
    study = pkg.create_study(directions=["minimize", "minimize"], sampler=sampler)
    study.optimize(lambda t: objective(t, dim=DIM), n_trials=POPULATION * GENERATIONS)
    return study


@pytest.mark.parametrize("device_branch", [False, True], ids=["host-sort", "device-branch"])
@pytest.mark.parametrize(
    "constrained,operators",
    [(False, "uniform"), (True, "uniform"), (False, "sbx+polynomial"), (False, "blx")],
)
def test_nsga2_zdt1_is_trial_for_trial_identical(monkeypatch, device_branch, constrained, operators):
    calls = []
    # Unconstrained pools of generations 2.. hold 2 * POPULATION = 16 feasible
    # points; constrained ones fewer, so their threshold goes lower still.
    threshold = 8 if constrained else 2 * POPULATION
    if device_branch:
        monkeypatch.setattr(_multi_objective, "_DEVICE_RANK_MIN_POINTS", threshold)
        rank_np = port_pareto.non_domination_rank_np
        monkeypatch.setattr(
            port_pareto, "non_domination_rank_np",
            lambda values, *, device=None: calls.append(len(values)) or rank_np(values, device=device),
        )
    ref = _run(optuna_tpu, ref_zdt1, constrained=constrained, operators=operators)
    port = _run(optuna_tpu_torch, benchmarks.zdt1, constrained=constrained, operators=operators, device="cpu")
    assert _summary(port) == _summary(ref)
    states = {t.state for t in port.get_trials(deepcopy=False)}
    assert states == {optuna_tpu_torch.TrialState.COMPLETE}
    cached = [k for k in _summary(port)[1] if ":population|" in k]
    assert len(cached) == GENERATIONS - 1
    if device_branch:
        assert len(calls) >= GENERATIONS - 2 and min(calls) >= threshold
    if constrained:
        feasible = [t for t in port.get_trials(deepcopy=False) if all(c <= 0 for c in t.system_attrs["constraints"])]
        assert 0 < len(feasible) < POPULATION * GENERATIONS


@pytest.mark.parametrize("name", ["zdt1", "zdt2", "zdt3"])
def test_zdt_objectives_equal_the_reference(name):
    import optuna_tpu.models.benchmarks as ref_benchmarks

    class _Fixed:
        def __init__(self, params):
            self.params = params

        def suggest_float(self, name, low, high):
            assert low <= self.params[name] <= high
            return self.params[name]

    rng = np.random.RandomState(0)
    for _ in range(5):
        trial = _Fixed({f"x{i}": float(v) for i, v in enumerate(rng.uniform(0, 1, size=30))})
        assert getattr(benchmarks, name)(trial) == getattr(ref_benchmarks, name)(trial)


def test_default_sampler_of_a_multi_objective_study_is_nsga2():
    from optuna_tpu_torch.samplers import NSGAIISampler

    study = optuna_tpu_torch.create_study(directions=["minimize", "maximize"])
    assert isinstance(study.sampler, NSGAIISampler)
    assert study.sampler._device is None  # resolved only where a large pool is ranked
    with pytest.raises(NotImplementedError, match="A4"):
        optuna_tpu_torch.create_study(direction="minimize")


def test_default_nsga2_ranks_small_pools_without_a_card():
    # population 4: every ranked pool has 8 < 512 points, so the host sort
    # runs and the device (None: the card) is never resolved.
    study = optuna_tpu_torch.create_study(
        directions=["minimize", "minimize"],
        sampler=optuna_tpu_torch.samplers.NSGAIISampler(seed=1, population_size=4),
    )
    study.optimize(lambda t: benchmarks.zdt2(t, dim=4), n_trials=16)
    assert len(study.best_trials) >= 1
