"""Pruner protocol (reference ``optuna/pruners/_base.py:11-33``)."""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING

from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class BasePruner(abc.ABC):
    @abc.abstractmethod
    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        """Judge whether ``trial`` should be pruned given its reported
        intermediate values. Called from ``Trial.should_prune``."""
        raise NotImplementedError
