"""Built-in optimize-loop callbacks (port of ``optuna_tpu/_callbacks.py``;
reference ``optuna/_callbacks.py:15``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Container

from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class MaxTrialsCallback:
    """Stop the study once ``n_trials`` trials (in the given states) exist.

    Unlike ``optimize(n_trials=...)`` this is a *cross-process* budget: every
    worker counts trials in the shared storage, so a fleet stops collectively.
    """

    def __init__(
        self,
        n_trials: int,
        states: Container[TrialState] | None = (TrialState.COMPLETE,),
    ) -> None:
        self._n_trials = n_trials
        self._states = states

    def __call__(self, study: "Study", trial: FrozenTrial) -> None:
        trials = study.get_trials(deepcopy=False, states=self._states)
        n_complete = len(trials)
        if n_complete >= self._n_trials:
            study.stop()


class RetryFailedTrialCallback:
    """Re-export of the storage retry callback for API parity; see
    :mod:`optuna_tpu_torch.storages._callbacks`."""

    def __new__(cls, *args, **kwargs):  # pragma: no cover - thin alias
        from optuna_tpu_torch.storages._callbacks import RetryFailedTrialCallback as _Impl

        return _Impl(*args, **kwargs)
