"""Hyperparameter importance (reference ``optuna/importance/__init__.py:27``).

Evaluators land in the analysis stage; ``get_param_importances`` is the
stable entry point.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

from optuna_tpu_torch.importance._base import BaseImportanceEvaluator

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

__all__ = [
    "BaseImportanceEvaluator",
    "get_param_importances",
    "FanovaImportanceEvaluator",
    "PedAnovaImportanceEvaluator",
    "MeanDecreaseImpurityImportanceEvaluator",
]

_LAZY = {
    "FanovaImportanceEvaluator": ("optuna_tpu_torch.importance._fanova", "FanovaImportanceEvaluator"),
    "PedAnovaImportanceEvaluator": ("optuna_tpu_torch.importance._ped_anova", "PedAnovaImportanceEvaluator"),
    "MeanDecreaseImpurityImportanceEvaluator": (
        "optuna_tpu_torch.importance._mean_decrease_impurity",
        "MeanDecreaseImpurityImportanceEvaluator",
    ),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_param_importances(
    study: "Study",
    *,
    evaluator=None,
    params: list[str] | None = None,
    target: Callable | None = None,
    normalize: bool = True,
) -> dict[str, float]:
    """Dispatch to an importance evaluator and optionally normalize to sum 1."""
    from optuna_tpu_torch.importance._evaluate import _get_param_importances

    return _get_param_importances(
        study, evaluator=evaluator, params=params, target=target, normalize=normalize
    )


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_LAZY))
