"""Generation bookkeeping shared by genetic-algorithm samplers.

Parity target: ``optuna/samplers/_ga/_base.py:17`` — trial generations are
tagged in trial system attrs, parent populations are cached in study system
attrs by generation, so any worker (process) can reconstruct the GA state
from storage alone.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING

from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class BaseGASampler(BaseSampler, abc.ABC):
    def __init_subclass__(cls, **kwargs) -> None:
        super().__init_subclass__(**kwargs)

    @classmethod
    def _generation_key(cls) -> str:
        return f"{cls.__name__}:generation"

    @classmethod
    def _population_cache_key(cls, generation: int) -> str:
        return f"{cls.__name__}:population|{generation}"

    def __init__(self, population_size: int) -> None:
        self._population_size = population_size

    @property
    def population_size(self) -> int:
        return self._population_size

    @abc.abstractmethod
    def select_parent(self, study: "Study", generation: int) -> list[FrozenTrial]:
        """Choose the parent population for ``generation`` from history."""
        raise NotImplementedError

    def get_trial_generation(self, study: "Study", trial: FrozenTrial) -> int:
        """Assign (and persist) the generation of a new trial: the latest
        generation with a full complement of completed trials spawns the next
        (reference ``_ga/_base.py:86``)."""
        generation = trial.system_attrs.get(self._generation_key())
        if generation is not None:
            return generation

        trials = study._get_trials(
            deepcopy=False, states=(TrialState.COMPLETE,), use_cache=True
        )
        max_generation = -1
        max_generation_count = 0
        key = self._generation_key()
        for t in trials:
            g = t.system_attrs.get(key, -1)
            if g > max_generation:
                max_generation, max_generation_count = g, 1
            elif g == max_generation:
                max_generation_count += 1

        if max_generation < 0:
            generation = 0
        elif max_generation_count >= self._population_size:
            generation = max_generation + 1
        else:
            generation = max_generation
        study._storage.set_trial_system_attr(trial._trial_id, key, generation)
        return generation

    def get_population(self, study: "Study", generation: int) -> list[FrozenTrial]:
        """Completed trials of one generation."""
        key = self._generation_key()
        return [
            t
            for t in study._get_trials(
                deepcopy=False, states=(TrialState.COMPLETE,), use_cache=True
            )
            if t.system_attrs.get(key) == generation
        ]

    def get_parent_population(self, study: "Study", generation: int) -> list[FrozenTrial]:
        """Elite parents for ``generation`` (cached in study system attrs as
        trial numbers, reference ``_ga/_base.py:154``)."""
        if generation == 0:
            return []
        cache_key = self._population_cache_key(generation)
        study_attrs = study._storage.get_study_system_attrs(study._study_id)
        cached = study_attrs.get(cache_key)
        all_trials = study._get_trials(deepcopy=False, use_cache=True)
        if cached is not None:
            by_number = {t.number: t for t in all_trials}
            return [by_number[n] for n in cached if n in by_number]

        parent_population = self.select_parent(study, generation)
        study._storage.set_study_system_attr(
            study._study_id, cache_key, [t.number for t in parent_population]
        )
        return parent_population
