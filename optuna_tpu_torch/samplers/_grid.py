"""Exhaustive grid sampler (port of ``optuna_tpu/samplers/_grid.py``;
reference ``optuna/samplers/_grid.py:33``).

The grid lives in study system attrs so multi-worker studies partition it;
visited combinations are tracked through trial system attrs and the study
stops via ``is_exhausted``. Unvisited grid ids are drawn with the host
RNG, so under ``n_jobs`` two workers may run one point twice, as in the
reference.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Any, Mapping, Sequence

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState

from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)

GridValueType = Any
_GRID_KEY = "grid_sampler:grid_id"


class GridSampler(BaseSampler):
    def __init__(
        self, search_space: Mapping[str, Sequence[GridValueType]], seed: int | None = None
    ) -> None:
        for param_name, param_values in search_space.items():
            for value in param_values:
                self._check_value(param_name, value)
        self._search_space = {k: list(v) for k, v in search_space.items()}
        self._all_grids = list(itertools.product(*self._search_space.values()))
        self._n_min_trials = len(self._all_grids)
        self._rng = LazyRandomState(seed)

    @staticmethod
    def _check_value(param_name: str, param_value: Any) -> None:
        if param_value is None or isinstance(param_value, (str, int, float, bool)):
            return
        message = (
            f"{param_value} contained in the grid for parameter {param_name} "
            "is not supported: it must be str, int, float, bool or None."
        )
        _logger.warning(message)

    def reseed_rng(self) -> None:
        self._rng.seed()

    def before_trial(self, study: "Study", trial: FrozenTrial) -> None:
        # Pick an unvisited grid id; when every id is claimed, stop the study
        # (or revisit at random, matching the reference's behaviour).
        target_grids = self._get_unvisited_grid_ids(study)
        if len(target_grids) == 0:
            _logger.warning(
                "GridSampler is re-evaluating a configuration because the grid has been exhausted."
            )
            target_grids = list(range(len(self._all_grids)))
        grid_id = int(self._rng.rng.choice(target_grids))
        study._storage.set_trial_system_attr(trial._trial_id, "search_space", self._search_space)
        study._storage.set_trial_system_attr(trial._trial_id, _GRID_KEY, grid_id)

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        if param_name not in self._search_space:
            message = f"The parameter name, {param_name}, is not found in the given grid."
            raise ValueError(message)
        grid_id = trial.system_attrs.get(_GRID_KEY)
        if grid_id is None:
            message = (
                "All parameters must be specified when using GridSampler with enqueue_trial."
            )
            raise RuntimeError(message)
        param_value = self._all_grids[grid_id][
            list(self._search_space.keys()).index(param_name)
        ]
        contains = param_distribution._contains(
            param_distribution.to_internal_repr(param_value)
        )
        if not contains:
            raise ValueError(
                f"The value {param_value} is out of the range of the parameter {param_name}."
            )
        return param_value

    def after_trial(
        self,
        study: "Study",
        trial: FrozenTrial,
        state: TrialState,
        values: Sequence[float] | None,
    ) -> None:
        if self._get_unvisited_grid_ids(study) == []:
            study.stop()

    def is_exhausted(self, study: "Study") -> bool:
        return len(self._get_unvisited_grid_ids(study)) == 0

    def _get_unvisited_grid_ids(self, study: "Study") -> list[int]:
        visited = set()
        running = set()
        for t in study.get_trials(deepcopy=False):
            gid = t.system_attrs.get(_GRID_KEY)
            if gid is None or not self._same_search_space(t.system_attrs.get("search_space", {})):
                continue
            if t.state.is_finished():
                visited.add(gid)
            elif t.state == TrialState.RUNNING:
                running.add(gid)
        return sorted(set(range(len(self._all_grids))) - visited - running)

    def _same_search_space(self, other: Mapping[str, Sequence[Any]]) -> bool:
        if set(other.keys()) != set(self._search_space.keys()):
            return False
        for k in other:
            if list(other[k]) != list(self._search_space[k]):
                return False
        return True
