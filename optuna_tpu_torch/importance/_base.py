"""Importance-evaluator protocol (reference ``optuna/importance/_base.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class BaseImportanceEvaluator:
    """Base of every importance evaluator: subclasses implement
    ``evaluate(study, params=None, *, target=None) -> dict[str, float]``."""

    def evaluate(
        self,
        study: "Study",
        params: list[str] | None = None,
        *,
        target: Callable | None = None,
    ) -> dict[str, float]:
        raise NotImplementedError
