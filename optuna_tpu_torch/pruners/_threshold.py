"""Absolute-threshold pruner (reference ``optuna/pruners/_threshold.py:29``)."""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

from optuna_tpu_torch.pruners._base import BasePruner
from optuna_tpu_torch.pruners._percentile import _is_first_in_interval_step
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


def _check_value(value: float | None, name: str) -> float:
    try:
        value = float(value)  # type: ignore[arg-type]
    except (TypeError, ValueError) as e:
        raise ValueError(f"The `{name}` should be a float, but got {value}.") from e
    return value


class ThresholdPruner(BasePruner):
    """Prune when an intermediate value leaves [lower, upper] or is NaN."""

    def __init__(
        self,
        lower: float | None = None,
        upper: float | None = None,
        n_warmup_steps: int = 0,
        interval_steps: int = 1,
    ) -> None:
        if lower is None and upper is None:
            raise ValueError("Either lower or upper must be specified.")
        self._lower = _check_value(lower, "lower") if lower is not None else -math.inf
        self._upper = _check_value(upper, "upper") if upper is not None else math.inf
        if n_warmup_steps < 0:
            raise ValueError(f"Number of warmup steps cannot be negative but got {n_warmup_steps}.")
        if interval_steps < 1:
            raise ValueError(f"Pruning interval steps must be at least 1 but got {interval_steps}.")
        self._n_warmup_steps = n_warmup_steps
        self._interval_steps = interval_steps

    def prune(self, study: "Study", trial: FrozenTrial) -> bool:
        step = trial.last_step
        if step is None:
            return False
        if step < self._n_warmup_steps:
            return False
        if not _is_first_in_interval_step(
            step, trial.intermediate_values.keys(), self._n_warmup_steps, self._interval_steps
        ):
            return False
        latest_value = trial.intermediate_values[step]
        if math.isnan(latest_value):
            return True
        return latest_value < self._lower or latest_value > self._upper
