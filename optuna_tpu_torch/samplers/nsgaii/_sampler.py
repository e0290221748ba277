"""NSGA-II sampler — the default multi-objective algorithm.

Parity target: ``optuna/samplers/nsgaii/_sampler.py:31`` with elite selection
(fast nondominated sort + crowding distance), binary-tournament parents,
pluggable crossovers, per-param mutation (uniform resample) and categorical
swap, constrained domination, and storage-externalized generation state via
:class:`optuna_tpu_torch.samplers._ga.BaseGASampler`.

``device`` is where the elite selection ranks a pool of at least
``_DEVICE_RANK_MIN_POINTS`` feasible trials (the dominance kernel): ``None``
means the card, resolved only when such a pool is ranked; smaller pools are
ranked on the host, as in the reference.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any, Callable, Sequence

import numpy as np
import torch

from optuna_tpu_torch.distributions import BaseDistribution, CategoricalDistribution
from optuna_tpu_torch.samplers._base import BaseSampler, _process_constraints_after_trial
from optuna_tpu_torch.samplers._ga import BaseGASampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers._random import RandomSampler
from optuna_tpu_torch.samplers.nsgaii._crossovers import BaseCrossover, UniformCrossover
from optuna_tpu_torch.samplers.nsgaii._elite import select_elite_population
from optuna_tpu_torch.samplers.nsgaii._mutations import BaseMutation, perform_mutation
from optuna_tpu_torch.search_space import IntersectionSearchSpace
from optuna_tpu_torch.transform import SearchSpaceTransform
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


def _plain_dominates(t0: FrozenTrial, t1: FrozenTrial, directions) -> bool:
    from optuna_tpu_torch.study._multi_objective import _dominates

    return _dominates(t0, t1, directions)


def _constrained_dominates(t0: FrozenTrial, t1: FrozenTrial, directions) -> bool:
    """Deb's constrained domination: feasible beats infeasible, less-violating
    beats more-violating, otherwise plain domination
    (reference ``nsgaii/_constraints_evaluation.py:19``)."""
    from optuna_tpu_torch.study._constrained_optimization import _constraints_list

    def violation(t: FrozenTrial) -> float:
        constraints = _constraints_list(t.system_attrs)
        if constraints is None:
            return float("inf")  # missing constraints rank behind everything
        return sum(max(c, 0.0) for c in constraints)

    v0, v1 = violation(t0), violation(t1)
    feas0, feas1 = v0 <= 0.0, v1 <= 0.0
    if feas0 and not feas1:
        return True
    if feas1 and not feas0:
        return False
    if not feas0 and not feas1:
        return v0 < v1
    return _plain_dominates(t0, t1, directions)


class NSGAIISampler(BaseGASampler):
    def __init__(
        self,
        *,
        population_size: int = 50,
        mutation: BaseMutation | None = None,
        mutation_prob: float | None = None,
        crossover: BaseCrossover | None = None,
        crossover_prob: float = 0.9,
        swapping_prob: float = 0.5,
        seed: int | None = None,
        constraints_func: Callable[[FrozenTrial], Sequence[float]] | None = None,
        elite_population_selection_strategy: (
            Callable[["Study", list[FrozenTrial], int], list[FrozenTrial]] | None
        ) = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        if population_size < 2:
            raise ValueError("`population_size` must be greater than or equal to 2.")
        if mutation is not None and not isinstance(mutation, BaseMutation):
            raise ValueError(f"'{mutation}' is not a valid mutation.")
        super().__init__(population_size=population_size)
        self._mutation = mutation
        self._mutation_prob = mutation_prob
        self._crossover = crossover or UniformCrossover(swapping_prob)
        self._crossover_prob = crossover_prob
        self._swapping_prob = swapping_prob
        self._rng = LazyRandomState(seed)
        self._random_sampler = RandomSampler(seed=seed)
        self._constraints_func = constraints_func
        self._device = None if device is None else torch.device(device)
        self._elite_selection = elite_population_selection_strategy or functools.partial(
            select_elite_population, device=self._device
        )
        self._search_space = IntersectionSearchSpace()

    def reseed_rng(self) -> None:
        self._rng.seed()
        self._random_sampler.reseed_rng()

    # ----------------------------------------------------------- GA plumbing

    def select_parent(self, study: "Study", generation: int) -> list[FrozenTrial]:
        parent = self.get_parent_population(study, generation - 1)
        population = self.get_population(study, generation - 1)
        return self._elite_selection(study, parent + population, self._population_size)

    # ----------------------------------------------------------- search space

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        search_space: dict[str, BaseDistribution] = {}
        for name, distribution in self._search_space.calculate(study).items():
            if distribution.single():
                continue
            search_space[name] = distribution
        return search_space

    # --------------------------------------------------------------- sampling

    def sample_relative(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        generation = self.get_trial_generation(study, trial)
        parent_population = self.get_parent_population(study, generation)
        if len(parent_population) < 2 or len(search_space) == 0:
            return {}  # generation 0: random initialization

        rng = self._rng.rng
        p0 = self._tournament_select(study, parent_population, rng)
        if rng.rand() < self._crossover_prob:
            parents = [p0]
            while len(parents) < self._crossover.n_parents:
                cand = self._tournament_select(study, parent_population, rng)
                parents.append(cand)
            child_params = self._crossover_params(parents, search_space, rng)
        else:
            child_params = {
                name: p0.params[name] for name in search_space if name in p0.params
            }

        # Mutation: per-gene with prob 1/d by default; the pluggable operator
        # perturbs numerical genes in transformed space, everything else (and
        # the default) resamples uniformly — matching the reference's
        # drop-then-independent-resample semantics
        # (``nsgaii/_child_generation_strategy.py:104-122``).
        mutation_prob = (
            self._mutation_prob
            if self._mutation_prob is not None
            else 1.0 / max(1, len(search_space))
        )
        for name, dist in search_space.items():
            if name not in child_params or rng.rand() < mutation_prob:
                mutated = None
                if self._mutation is not None and name in child_params:
                    mutated = perform_mutation(
                        self._mutation, rng, study, dist, child_params[name]
                    )
                if mutated is not None:
                    child_params[name] = mutated
                else:
                    child_params[name] = self._random_sampler.sample_independent(
                        study, trial, name, dist
                    )
        return child_params

    def _tournament_select(
        self, study: "Study", population: list[FrozenTrial], rng: np.random.RandomState
    ) -> FrozenTrial:
        a, b = rng.choice(len(population), 2, replace=False)
        ta, tb = population[int(a)], population[int(b)]
        dominates = (
            _constrained_dominates if self._constraints_func is not None else _plain_dominates
        )
        if dominates(ta, tb, study.directions):
            return ta
        if dominates(tb, ta, study.directions):
            return tb
        return ta if rng.rand() < 0.5 else tb

    def _crossover_params(
        self,
        parents: list[FrozenTrial],
        search_space: dict[str, BaseDistribution],
        rng: np.random.RandomState,
    ) -> dict[str, Any]:
        """Numerical genes go through the crossover operator in transformed
        space; categorical genes are inherited uniformly (reference
        ``nsgaii/_crossover.py:84,167``)."""
        numerical_space = {
            k: v for k, v in search_space.items()
            if not isinstance(v, CategoricalDistribution)
        }
        child: dict[str, Any] = {}

        if numerical_space:
            usable = [p for p in parents if all(k in p.params for k in numerical_space)]
            if len(usable) >= self._crossover.n_parents:
                trans = SearchSpaceTransform(numerical_space, transform_0_1=False)
                parent_vecs = np.stack(
                    [trans.transform({k: p.params[k] for k in numerical_space}) for p in usable[: self._crossover.n_parents]]
                )
                child_vec = self._crossover.crossover(parent_vecs, rng, trans.bounds)
                child.update(trans.untransform(np.clip(child_vec, trans.bounds[:, 0], trans.bounds[:, 1])))

        for name, dist in search_space.items():
            if isinstance(dist, CategoricalDistribution):
                donors = [p for p in parents if name in p.params]
                if donors:
                    # Uniform per-gene parent choice (all parents eligible).
                    child[name] = donors[rng.randint(len(donors))].params[name]
        return child

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        return self._random_sampler.sample_independent(
            study, trial, param_name, param_distribution
        )

    def before_trial(self, study: "Study", trial: FrozenTrial) -> None:
        self.get_trial_generation(study, trial)

    def after_trial(
        self,
        study: "Study",
        trial: FrozenTrial,
        state: TrialState,
        values: Sequence[float] | None,
    ) -> None:
        if self._constraints_func is not None:
            _process_constraints_after_trial(self._constraints_func, study, trial, state)
