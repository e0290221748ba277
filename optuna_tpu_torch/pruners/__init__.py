"""Pruners package (reference ``optuna_tpu/pruners/__init__.py``): the base,
the default MedianPruner with the PercentilePruner it specializes, and
NopPruner; the Patient, Threshold, SuccessiveHalving, Hyperband and Wilcoxon
pruners load lazily."""

from __future__ import annotations

from typing import TYPE_CHECKING

from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.pruners._median import MedianPruner
from optuna_tpu_torch.pruners._nop import NopPruner
from optuna_tpu_torch.pruners._percentile import PercentilePruner
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

__all__ = [
    "BasePruner",
    "MedianPruner",
    "NopPruner",
    "PercentilePruner",
    "PatientPruner",
    "ThresholdPruner",
    "SuccessiveHalvingPruner",
    "HyperbandPruner",
    "WilcoxonPruner",
    "_filter_study",
]


def _filter_study(study: "Study", trial: FrozenTrial) -> "Study":
    """Give Hyperband its bracket-restricted view of the study; identity for
    every other pruner (reference ``optuna_tpu/pruners/__init__.py:30-36``)."""
    pruner = study.pruner
    if type(pruner).__name__ == "HyperbandPruner" and hasattr(pruner, "_create_bracket_study"):
        return pruner._create_bracket_study(study, trial)  # type: ignore[attr-defined]
    return study


_LAZY = {
    "PatientPruner": "optuna_tpu_torch.pruners._patient",
    "ThresholdPruner": "optuna_tpu_torch.pruners._threshold",
    "SuccessiveHalvingPruner": "optuna_tpu_torch.pruners._successive_halving",
    "HyperbandPruner": "optuna_tpu_torch.pruners._hyperband",
    "WilcoxonPruner": "optuna_tpu_torch.pruners._wilcoxon",
}


def __getattr__(name: str):  # lazily expose the heavier pruners
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_LAZY))
