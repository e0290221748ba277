"""Sampler protocol: the two-phase relative/independent contract.

Parity target: ``optuna/samplers/_base.py:33-230`` plus the constraints
post-processing hook (``:240``). The define-by-run search space is discovered
as the objective runs, so a sampler gets two chances per trial:

1. ``infer_relative_search_space`` + ``sample_relative`` — once, at the first
   ``suggest_*`` call, over the jointly-inferred space (the batched, jittable
   path on this framework);
2. ``sample_independent`` — per-parameter fallback for params outside the
   relative space (host-side scalar path).
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Any, Callable, Sequence

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


_CONSTRAINTS_KEY = "constraints"


class BaseSampler(abc.ABC):
    """Base of every suggestion algorithm."""

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        """Search space jointly sampled by :meth:`sample_relative` for this trial."""
        return {}

    def sample_relative(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        """Jointly sample the relative space; returns external-repr values."""
        return {}

    @abc.abstractmethod
    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        """Sample a single parameter outside the relative space."""
        raise NotImplementedError

    def before_trial(self, study: "Study", trial: FrozenTrial) -> None:
        """Hook at trial start (before any suggestion)."""

    def after_trial(
        self,
        study: "Study",
        trial: FrozenTrial,
        state: TrialState,
        values: Sequence[float] | None,
    ) -> None:
        """Hook at trial end, before the final state is written."""

    def reseed_rng(self) -> None:
        """Reseed internal RNG (called per worker thread/process fork)."""

    def _raise_error_if_multi_objective(self, study: "Study") -> None:
        if study._is_multi_objective():
            raise ValueError(
                f"If the study is being used for multi-objective optimization, "
                f"{self.__class__.__name__} cannot be used."
            )

    def __str__(self) -> str:
        return self.__class__.__name__


def _process_constraints_after_trial(
    constraints_func: Callable[[FrozenTrial], Sequence[float]] | None,
    study: "Study",
    trial: FrozenTrial,
    state: TrialState,
) -> None:
    """Evaluate and persist the user's constraints for a finished trial.

    Constraints are feasible iff every component <= 0; stored under the
    ``constraints`` system attr (reference ``samplers/_base.py:240-266``).
    Failure of the constraints function fails the surrounding trial.
    """
    if constraints_func is None:
        return
    if state not in (TrialState.COMPLETE, TrialState.PRUNED):
        return
    constraints = None
    try:
        con = constraints_func(trial)
        if not isinstance(con, (tuple, list)):
            con = tuple(con)
        constraints = tuple(float(c) for c in con)
    finally:
        assert constraints is None or isinstance(constraints, tuple)
        study._storage.set_trial_system_attr(
            trial._trial_id, _CONSTRAINTS_KEY, constraints
        )
