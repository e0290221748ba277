"""The sampler contract on every ported sampler, on the CPU.

The port's copy of the reference's shipped suites
(``optuna_tpu_torch/testing/pytest_samplers.py``) over the port's samplers,
each with ``device="cpu"`` where it takes one: Random, TPE (univariate,
multivariate, multivariate + group), GP, CMA-ES, QMC, NSGA-II, NSGA-III,
BruteForce (enumerable spaces only) and PartialFixed, as the reference's
``tests/test_sampler_contract.py`` runs its matrix. Grid needs an explicit
grid and has its own cases. GP starts fitting at trial 5 (the reference's
matrix: 3) and samples with a small acquisition pool
(``n_preliminary_samples=128``, ``n_local_search=2``), to keep the CPU time
down: every case still runs GP asks, and the contract does not depend on
the pool's size. GP runs on several objectives (LogEHVI) and with
constraints, as in the reference's matrix.
"""

from __future__ import annotations

import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch import TrialState, create_study
from optuna_tpu_torch.samplers import (
    BruteForceSampler,
    CmaEsSampler,
    GPSampler,
    GridSampler,
    NSGAIIISampler,
    NSGAIISampler,
    PartialFixedSampler,
    QMCSampler,
    RandomSampler,
    TPESampler,
)
from optuna_tpu_torch.testing.pytest_samplers import (
    BasicSamplerTestCase,
    ConstrainedSamplerTestCase,
    MultiObjectiveSamplerTestCase,
    RelativeSamplerTestCase,
    SeededSamplerTestCase,
)
from tests._torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
optuna_tpu.logging.set_verbosity(optuna_tpu.logging.WARNING)

CPU = "cpu"
GP_POOL = dict(n_preliminary_samples=128, n_local_search=2)

SAMPLER_FACTORIES = {
    "random": lambda **kw: RandomSampler(seed=kw.get("seed", 0)),
    "tpe": lambda **kw: TPESampler(seed=kw.get("seed", 0), n_startup_trials=3, device=CPU),
    "tpe-mv": lambda **kw: TPESampler(seed=kw.get("seed", 0), n_startup_trials=3, multivariate=True, device=CPU),
    "tpe-mv-group": lambda **kw: TPESampler(
        seed=kw.get("seed", 0), n_startup_trials=3, multivariate=True, group=True, device=CPU
    ),
    "gp": lambda **kw: GPSampler(seed=kw.get("seed", 0), n_startup_trials=5, device=CPU, **GP_POOL),
    "cmaes": lambda **kw: CmaEsSampler(seed=kw.get("seed", 0), warn_independent_sampling=False, device=CPU),
    "qmc": lambda **kw: QMCSampler(
        seed=kw.get("seed", 0), warn_independent_sampling=False, warn_asynchronous_seeding=False
    ),
    "nsga2": lambda **kw: NSGAIISampler(seed=kw.get("seed", 0), population_size=4, device=CPU),
    "nsga3": lambda **kw: NSGAIIISampler(seed=kw.get("seed", 0), population_size=4, device=CPU),
    "bruteforce": lambda **kw: BruteForceSampler(seed=kw.get("seed", 0)),
    "partial-fixed": lambda **kw: PartialFixedSampler({"fixed": 0.5}, RandomSampler(seed=kw.get("seed", 0))),
    "partial-fixed-tpe": lambda **kw: PartialFixedSampler(
        {"fixed": 0.5}, TPESampler(seed=kw.get("seed", 0), n_startup_trials=3, device=CPU)
    ),
}

# BruteForce only handles enumerable spaces; Grid needs an explicit grid —
# they get their own cases instead of the generic continuous-space matrix.
CONTINUOUS_CAPABLE = [k for k in SAMPLER_FACTORIES if k != "bruteforce"]
MULTI_OBJECTIVE_CAPABLE = ["random", "tpe", "tpe-mv", "gp", "nsga2", "nsga3", "qmc"]
SEEDED_REPRODUCIBLE = ["random", "tpe", "tpe-mv", "gp", "cmaes", "qmc", "nsga2", "nsga3", "partial-fixed"]
RELATIVE_CAPABLE = ["tpe-mv", "gp", "cmaes"]
CONSTRAINED_CAPABLE = {
    "tpe-c": lambda cfn: TPESampler(seed=0, n_startup_trials=3, constraints_func=cfn, device=CPU),
    "gp-c": lambda cfn: GPSampler(seed=0, n_startup_trials=3, constraints_func=cfn, device=CPU, **GP_POOL),
    "nsga2-c": lambda cfn: NSGAIISampler(seed=0, population_size=4, constraints_func=cfn, device=CPU),
    "nsga3-c": lambda cfn: NSGAIIISampler(seed=0, population_size=4, constraints_func=cfn, device=CPU),
}


class TestBasicContract(BasicSamplerTestCase):
    @pytest.fixture(params=CONTINUOUS_CAPABLE)
    def sampler_factory(self, request):
        return SAMPLER_FACTORIES[request.param]


class TestSeededContract(SeededSamplerTestCase):
    @pytest.fixture(params=SEEDED_REPRODUCIBLE)
    def sampler_factory(self, request):
        return SAMPLER_FACTORIES[request.param]


class TestRelativeContract(RelativeSamplerTestCase):
    @pytest.fixture(params=RELATIVE_CAPABLE)
    def sampler_factory(self, request):
        return SAMPLER_FACTORIES[request.param]


class TestMultiObjectiveContract(MultiObjectiveSamplerTestCase):
    @pytest.fixture(params=MULTI_OBJECTIVE_CAPABLE)
    def sampler_factory(self, request):
        return SAMPLER_FACTORIES[request.param]


class TestConstrainedContract(ConstrainedSamplerTestCase):
    @pytest.fixture(params=sorted(CONSTRAINED_CAPABLE))
    def constrained_factory(self, request):
        return CONSTRAINED_CAPABLE[request.param]


def test_the_suites_are_the_reference_suites():
    """The port's copy holds the reference's cases, name for name."""
    from optuna_tpu.testing import pytest_samplers as ref
    from optuna_tpu_torch.testing import pytest_samplers as port

    for name in ("BasicSamplerTestCase", "SeededSamplerTestCase", "RelativeSamplerTestCase",
                 "MultiObjectiveSamplerTestCase", "ConstrainedSamplerTestCase"):
        cases = lambda mod: sorted(k for k in vars(getattr(mod, name)) if k.startswith("test_"))  # noqa: E731
        assert cases(port) == cases(ref), name


# -------------------------------------------------------- sampler specifics


def test_grid_sampler_reports_all_combinations():
    grid = {"x": [0, 1, 2], "c": ["a", "b"]}
    study = create_study(sampler=GridSampler(grid, seed=0))
    study.optimize(
        lambda t: t.suggest_int("x", 0, 2) + (0.0 if t.suggest_categorical("c", ["a", "b"]) == "a" else 0.5),
        n_trials=100,
    )
    seen = {(t.params["x"], t.params["c"]) for t in study.trials}
    assert seen == {(x, c) for x in grid["x"] for c in grid["c"]}
    assert len(study.trials) == 6


def test_grid_sampler_seeded_order_reproducible():
    grid = {"x": [0, 1, 2, 3, 4, 5]}
    orders = []
    for _ in range(2):
        study = create_study(sampler=GridSampler(grid, seed=11))
        study.optimize(lambda t: t.suggest_int("x", 0, 5), n_trials=6)
        orders.append([t.params["x"] for t in study.trials])
    assert orders[0] == orders[1]


def test_partial_fixed_overrides_nested_sampler():
    sampler = PartialFixedSampler({"lr": 0.01}, TPESampler(seed=0, n_startup_trials=2, device=CPU))
    study = create_study(sampler=sampler)
    study.optimize(
        lambda t: t.suggest_float("lr", 1e-5, 1.0, log=True) + t.suggest_float("wd", 0.0, 1.0),
        n_trials=8,
    )
    assert all(t.params["lr"] == 0.01 for t in study.trials)


def test_bruteforce_marks_exhaustion_via_stop():
    study = create_study(sampler=BruteForceSampler(seed=0))
    study.optimize(lambda t: float(t.suggest_int("k", 0, 3)), n_trials=50)
    assert len(study.trials) == 4
    assert sorted(t.params["k"] for t in study.trials) == [0, 1, 2, 3]


@pytest.mark.parametrize("name", ["tpe", "gp"])
def test_model_based_beats_random_on_quadratic(name):
    """Model-based samplers should out-optimize random search on a smooth 2D
    quadratic with an equal 25-trial budget (the reference's bound)."""

    def objective(trial) -> float:
        x = trial.suggest_float("x", -5.0, 5.0)
        y = trial.suggest_float("y", -5.0, 5.0)
        return (x - 1.0) ** 2 + (y + 2.0) ** 2

    model = create_study(sampler=SAMPLER_FACTORIES[name](seed=5))
    model.optimize(objective, n_trials=25)
    rand = create_study(sampler=RandomSampler(seed=5))
    rand.optimize(objective, n_trials=25)
    assert model.best_value <= rand.best_value * 1.5 + 0.5


def test_sampler_after_trial_called_on_failure():
    events = []

    class Spy(RandomSampler):
        def after_trial(self, study, trial, state, values):
            events.append((trial.number, state))
            super().after_trial(study, trial, state, values)

    study = create_study(sampler=Spy(seed=0))

    def objective(trial):
        trial.suggest_float("x", 0, 1)
        if trial.number == 1:
            raise ValueError()
        return 0.0

    study.optimize(objective, n_trials=3, catch=(ValueError,))
    assert [s for _, s in events] == [TrialState.COMPLETE, TrialState.FAIL, TrialState.COMPLETE]
