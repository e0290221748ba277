"""Importance dispatcher (reference ``optuna/importance/__init__.py:27``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np

from optuna_tpu_torch.search_space import intersection_search_space
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


def _get_filtered_trials(
    study: "Study", params: list[str] | None, target: Callable | None
) -> tuple[list[FrozenTrial], list[str]]:
    trials = [t for t in study.get_trials(deepcopy=False) if t.state == TrialState.COMPLETE]
    if target is None and study._is_multi_objective():
        raise ValueError(
            "If the study is being used for multi-objective optimization, "
            "please specify the `target`."
        )
    if params is None:
        space = intersection_search_space(trials)
        params = [k for k, v in space.items() if not v.single()]
    trials = [t for t in trials if all(p in t.params for p in params)]
    if len(trials) == 0:
        raise ValueError("The study does not contain completed trials with the target params.")
    return trials, params


def _target_values(trials: list[FrozenTrial], target: Callable | None) -> np.ndarray:
    if target is not None:
        return np.asarray([target(t) for t in trials], dtype=np.float64)
    return np.asarray([t.value for t in trials], dtype=np.float64)


def _get_param_importances(
    study: "Study",
    *,
    evaluator=None,
    params: list[str] | None = None,
    target: Callable | None = None,
    normalize: bool = True,
) -> dict[str, float]:
    if evaluator is None:
        from optuna_tpu_torch.importance._fanova import FanovaImportanceEvaluator

        evaluator = FanovaImportanceEvaluator()
    importances = evaluator.evaluate(study, params=params, target=target)
    if normalize:
        total = sum(importances.values())
        if total > 0:
            importances = {k: v / total for k, v in importances.items()}
    return importances
