"""Group-decomposed search space (re-homed copy of ``optuna_tpu/search_space/group_decomposed.py``;
reference ``optuna/search_space/group_decomposed.py:14,40``).

Partitions discovered parameters into maximal groups that always co-occur,
so TPE ``group=True`` can model each group with its own joint KDE.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class _GroupDecomposedSearchSpace:
    def __init__(self, include_pruned: bool = False) -> None:
        self._search_space = _SearchSpaceGroup()
        self._study_id: int | None = None
        self._include_pruned = include_pruned

    def calculate(self, study: "Study") -> "_SearchSpaceGroup":
        if self._study_id is None:
            self._study_id = study._study_id
        elif self._study_id != study._study_id:
            raise ValueError("`_GroupDecomposedSearchSpace` cannot handle multiple studies.")

        states_of_interest = [TrialState.COMPLETE]
        if self._include_pruned:
            states_of_interest.append(TrialState.PRUNED)
        for trial in study._get_trials(deepcopy=False, states=states_of_interest, use_cache=True):
            self._search_space.add_distributions(trial.distributions)
        return self._search_space


class _SearchSpaceGroup:
    def __init__(self) -> None:
        self._search_spaces: list[dict[str, BaseDistribution]] = []

    @property
    def search_spaces(self) -> list[dict[str, BaseDistribution]]:
        return self._search_spaces

    def add_distributions(self, distributions: dict[str, BaseDistribution]) -> None:
        dist_keys = set(distributions.keys())
        next_spaces: list[dict[str, BaseDistribution]] = []
        for search_space in self._search_spaces:
            keys = set(search_space.keys())
            overlap = keys & dist_keys
            if len(overlap) == 0:
                next_spaces.append(search_space)
                continue
            if overlap == keys:
                next_spaces.append(search_space)
                dist_keys -= overlap
                continue
            # Split the group into the co-occurring part and the rest.
            next_spaces.append({k: search_space[k] for k in overlap})
            next_spaces.append({k: search_space[k] for k in keys - overlap})
            dist_keys -= overlap
        if len(dist_keys) > 0:
            next_spaces.append({k: distributions[k] for k in distributions if k in dist_keys})
        self._search_spaces = next_spaces
