"""Never-prune pruner (reference ``optuna/pruners/_nop.py:13``)."""

from __future__ import annotations

from typing import TYPE_CHECKING

from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class NopPruner(BasePruner):
    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        return False
