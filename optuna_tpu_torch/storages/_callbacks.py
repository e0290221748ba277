"""Failed-trial retry callbacks (port of ``optuna_tpu/storages/_callbacks.py``;
reference ``optuna/storages/_callbacks.py:17-141``).

Both callbacks re-enqueue a WAITING clone of a failed trial carrying
``failed_trial``/``retry_history`` system attrs so importance/visualization
can trace retry lineages.
"""

from __future__ import annotations

import copy
from typing import TYPE_CHECKING

from optuna_tpu_torch.trial._frozen import FrozenTrial, create_trial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

#: System-attr namespace owned by the vectorized batch executor
#: (:mod:`optuna_tpu_torch.parallel.executor`). Everything under this prefix is
#: bookkeeping about one *physical dispatch* (batch id, slot index) — it
#: describes the dead attempt, not the logical trial, so retry callbacks
#: strip it when cloning: a WAITING clone will be re-dispatched in a new
#: batch that writes its own fresh attrs. Keys like ``failed_trial`` /
#: ``retry_history`` / ``fixed_params`` are deliberately *outside* this
#: namespace — retry lineage must survive the copy.
EXECUTOR_ATTR_PREFIX = "batch_exec:"


class RetryFailedTrialCallback:
    """``failed_trial_callback`` for storages: re-enqueue failed trials.

    ``max_retry=None`` retries forever; ``inherit_intermediate_values`` copies
    reported steps into the clone.
    """

    def __init__(
        self, max_retry: int | None = None, inherit_intermediate_values: bool = False
    ) -> None:
        self._max_retry = max_retry
        self._inherit_intermediate_values = inherit_intermediate_values

    def __call__(self, study: "Study", trial: FrozenTrial) -> None:
        # Executor-owned dispatch bookkeeping must not leak into the clone
        # (see EXECUTOR_ATTR_PREFIX above); lineage attrs are kept.
        # ``fail_reason`` predates the namespace but is the same category —
        # it diagnoses the dead attempt, and a clone that later COMPLETEs
        # must not still claim a dispatch crash (the reason stays readable
        # on the original trial the lineage attrs point at).
        system_attrs = {
            k: v
            for k, v in trial.system_attrs.items()
            if not k.startswith(EXECUTOR_ATTR_PREFIX) and k != "fail_reason"
        }
        retry_history = list(system_attrs.get("retry_history", []))
        original_trial_number = system_attrs.get("failed_trial", trial.number)
        retry_history.append(trial.number)
        if self._max_retry is not None and len(retry_history) > self._max_retry:
            return

        system_attrs["failed_trial"] = original_trial_number
        system_attrs["retry_history"] = retry_history
        system_attrs["fixed_params"] = trial.params
        retried = create_trial(
            state=TrialState.WAITING,
            params=trial.params,
            distributions=trial.distributions,
            user_attrs=trial.user_attrs,
            system_attrs=system_attrs,
            intermediate_values=(
                copy.deepcopy(trial.intermediate_values)
                if self._inherit_intermediate_values
                else None
            ),
        )
        study.add_trial(retried)

    @staticmethod
    def retried_trial_number(trial: FrozenTrial) -> int | None:
        return trial.system_attrs.get("failed_trial")

    @staticmethod
    def retry_history(trial: FrozenTrial) -> list[int]:
        return list(trial.system_attrs.get("retry_history", []))


# Heartbeat-flavoured alias kept for reference-API parity
# (reference ``storages/_callbacks.py:17`` vs ``:84``).
RetryHeartbeatStaleTrialCallback = RetryFailedTrialCallback
