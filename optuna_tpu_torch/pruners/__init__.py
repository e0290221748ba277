"""Pruners package: the base and the default MedianPruner (with the
PercentilePruner it specializes) (reference ``optuna_tpu/pruners/__init__.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING

from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.pruners._median import MedianPruner
from optuna_tpu_torch.pruners._percentile import PercentilePruner
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

__all__ = ["BasePruner", "MedianPruner", "PercentilePruner", "_filter_study"]


def _filter_study(study: "Study", trial: FrozenTrial) -> "Study":
    """Identity: Hyperband's bracket-restricted view is not ported yet
    (reference ``optuna_tpu/pruners/__init__.py:_filter_study``)."""
    return study
