"""Storage abstraction — the distributed-coordination contract.

Parity target: ``optuna/storages/_base.py:21-607`` (25-method ABC). The
consistency contract for multi-worker studies (reference docstring
``_base.py:21-51``) is preserved:

* a worker always reads its own writes for trials it owns;
* trial numbers are assigned atomically and densely per study;
* ``set_trial_state_values`` acts as a compare-and-set when promoting a
  WAITING trial to RUNNING and returns ``False`` on a lost race — this CAS is
  the *only* cross-worker synchronization primitive in the system.
"""

from __future__ import annotations

import abc
from typing import Any, Container, Sequence

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.exceptions import UpdateFinishedTrialError
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState


DEFAULT_STUDY_NAME_PREFIX = "no-name-"


class BaseStorage(abc.ABC):
    """Abstract storage: study/trial CRUD plus attribute buses."""

    # ------------------------------------------------------------------ study

    @abc.abstractmethod
    def create_new_study(
        self, directions: Sequence[StudyDirection], study_name: str | None = None
    ) -> int:
        """Create a study and return its ``study_id``.

        Raises ``DuplicatedStudyError`` when ``study_name`` already exists.
        """
        raise NotImplementedError

    @abc.abstractmethod
    def delete_study(self, study_id: int) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def get_study_id_from_name(self, study_name: str) -> int:
        raise NotImplementedError

    @abc.abstractmethod
    def get_study_name_from_id(self, study_id: int) -> str:
        raise NotImplementedError

    @abc.abstractmethod
    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        raise NotImplementedError

    @abc.abstractmethod
    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        raise NotImplementedError

    @abc.abstractmethod
    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        raise NotImplementedError

    @abc.abstractmethod
    def get_all_studies(self) -> list["FrozenStudy"]:
        raise NotImplementedError

    # ------------------------------------------------------------------ trial

    @abc.abstractmethod
    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        """Create a trial (RUNNING, or a copy of ``template_trial``) and return trial_id."""
        raise NotImplementedError

    @abc.abstractmethod
    def set_trial_param(
        self,
        trial_id: int,
        param_name: str,
        param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        raise NotImplementedError

    def get_trial_id_from_study_id_trial_number(self, study_id: int, trial_number: int) -> int:
        trials = self.get_all_trials(study_id, deepcopy=False)
        if len(trials) <= trial_number or trials[trial_number].number != trial_number:
            for t in trials:
                if t.number == trial_number:
                    return t._trial_id
            raise KeyError(
                f"No trial with trial number {trial_number} exists in study {study_id}."
            )
        return trials[trial_number]._trial_id

    def get_trial_number_from_id(self, trial_id: int) -> int:
        return self.get_trial(trial_id).number

    def get_trial_param(self, trial_id: int, param_name: str) -> float:
        trial = self.get_trial(trial_id)
        return trial.distributions[param_name].to_internal_repr(trial.params[param_name])

    @abc.abstractmethod
    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Sequence[float] | None = None
    ) -> bool:
        """Write final/claimed state; return False iff a WAITING->RUNNING CAS lost."""
        raise NotImplementedError

    @abc.abstractmethod
    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        raise NotImplementedError

    @abc.abstractmethod
    def get_trial(self, trial_id: int) -> FrozenTrial:
        raise NotImplementedError

    @abc.abstractmethod
    def get_all_trials(
        self,
        study_id: int,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
    ) -> list[FrozenTrial]:
        raise NotImplementedError

    def get_n_trials(
        self, study_id: int, state: tuple[TrialState, ...] | TrialState | None = None
    ) -> int:
        if isinstance(state, TrialState):
            state = (state,)
        return len(self.get_all_trials(study_id, deepcopy=False, states=state))

    def get_best_trial(self, study_id: int) -> FrozenTrial:
        """Single-objective best trial (reference ``_base.py:421``)."""
        all_trials = self.get_all_trials(study_id, deepcopy=False, states=(TrialState.COMPLETE,))
        all_trials = [t for t in all_trials if t.value is not None]
        if len(all_trials) == 0:
            raise ValueError("No trials are completed yet.")
        directions = self.get_study_directions(study_id)
        if len(directions) > 1:
            raise RuntimeError(
                "Best trial can be obtained only for single-objective optimization."
            )
        if directions[0] == StudyDirection.MAXIMIZE:
            return max(all_trials, key=lambda t: t.value)  # type: ignore[arg-type]
        return min(all_trials, key=lambda t: t.value)  # type: ignore[arg-type]

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        """Create ``n`` trials, returning their ids in creation order.

        Batch-ask fast path for vectorized optimization: backends override to
        amortize their commit cost (one lock/fsync/transaction for the whole
        batch) while preserving per-trial id/number assignment semantics.
        """
        return [self.create_new_trial(study_id, template_trial) for _ in range(n)]

    def _read_trials_partial(
        self, study_id: int, max_known_trial_id: int, extra_ids: "Container[int] | set[int]"
    ) -> list[FrozenTrial]:
        """Incremental read: trials newer than ``max_known_trial_id`` plus the
        explicitly listed (unfinished) ids.

        The contract behind ``_CachedStorage``'s contiguous-watermark cache.
        Backends override with an indexed query (RDB) or serve it remotely
        (gRPC — keeping per-poll wire traffic proportional to *new* trials,
        not study size); this generic version filters a full read.
        """
        extra = set(extra_ids)
        return [
            t
            for t in self.get_all_trials(study_id, deepcopy=False)
            if t._trial_id > max_known_trial_id or t._trial_id in extra
        ]

    # ------------------------------------------------- convenience accessors

    def get_trial_params(self, trial_id: int) -> dict[str, Any]:
        """Parameter dict (external repr) of a trial (reference ``_base.py:550``)."""
        return self.get_trial(trial_id).params

    def get_trial_user_attrs(self, trial_id: int) -> dict[str, Any]:
        """User attributes of a trial (reference ``_base.py:566``)."""
        return self.get_trial(trial_id).user_attrs

    def get_trial_system_attrs(self, trial_id: int) -> dict[str, Any]:
        """Framework-internal attributes of a trial (reference ``_base.py:583``)."""
        return self.get_trial(trial_id).system_attrs

    def check_trial_is_updatable(self, trial_id: int, trial_state: TrialState) -> None:
        """Raise :exc:`UpdateFinishedTrialError` for finished trials
        (reference ``_base.py:603``)."""
        if trial_state.is_finished():
            trial = self.get_trial(trial_id)
            raise UpdateFinishedTrialError(
                f"Trial#{trial.number} has already finished and can not be updated."
            )

    # -------------------------------------------------------------- lifecycle

    def remove_session(self) -> None:
        """Release per-process resources (connections, locks)."""

    def __getstate__(self) -> dict[str, Any]:
        return self.__dict__.copy()


class _ForwardingStorage(BaseStorage):
    """Transparent delegating wrapper around another storage.

    Base class for storage *decorators* — :class:`RetryingStorage`,
    :class:`FaultInjectorStorage` — that need the full 25-method surface plus
    the heartbeat mixin without re-implementing it. Every primitive call
    funnels through :meth:`_forward`, the single override point; the derived
    convenience methods inherited from :class:`BaseStorage` compose the
    (decorated) primitives, so subclass behavior covers them automatically.

    Heartbeat methods delegate when the backend supports them and degrade to
    "heartbeat disabled" otherwise, matching the gRPC server's treatment of
    non-heartbeat backings.
    """

    def __init__(self, backend: BaseStorage) -> None:
        self._backend = backend

    def _forward(self, method: str, *args: Any, **kwargs: Any) -> Any:
        return getattr(self._backend, method)(*args, **kwargs)

    # ------------------------------------------------------------------ study

    def create_new_study(
        self, directions: Sequence[StudyDirection], study_name: str | None = None
    ) -> int:
        return self._forward("create_new_study", directions, study_name)

    def delete_study(self, study_id: int) -> None:
        self._forward("delete_study", study_id)

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        self._forward("set_study_user_attr", study_id, key, value)

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        self._forward("set_study_system_attr", study_id, key, value)

    def get_study_id_from_name(self, study_name: str) -> int:
        return self._forward("get_study_id_from_name", study_name)

    def get_study_name_from_id(self, study_id: int) -> str:
        return self._forward("get_study_name_from_id", study_id)

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        return self._forward("get_study_directions", study_id)

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        return self._forward("get_study_user_attrs", study_id)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        return self._forward("get_study_system_attrs", study_id)

    def get_all_studies(self) -> list["FrozenStudy"]:
        return self._forward("get_all_studies")

    # ------------------------------------------------------------------ trial

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        return self._forward("create_new_trial", study_id, template_trial)

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        return self._forward("create_new_trials", study_id, n, template_trial)

    def set_trial_param(
        self,
        trial_id: int,
        param_name: str,
        param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        self._forward("set_trial_param", trial_id, param_name, param_value_internal, distribution)

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Sequence[float] | None = None
    ) -> bool:
        return self._forward("set_trial_state_values", trial_id, state, values)

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        self._forward("set_trial_intermediate_value", trial_id, step, intermediate_value)

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._forward("set_trial_user_attr", trial_id, key, value)

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._forward("set_trial_system_attr", trial_id, key, value)

    def get_trial(self, trial_id: int) -> FrozenTrial:
        return self._forward("get_trial", trial_id)

    def get_all_trials(
        self,
        study_id: int,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
    ) -> list[FrozenTrial]:
        return self._forward("get_all_trials", study_id, deepcopy, states)

    def _read_trials_partial(
        self, study_id: int, max_known_trial_id: int, extra_ids: "Container[int] | set[int]"
    ) -> list[FrozenTrial]:
        return self._forward("_read_trials_partial", study_id, max_known_trial_id, extra_ids)

    # -------------------------------------------------------------- heartbeat

    def record_heartbeat(self, trial_id: int) -> None:
        if hasattr(self._backend, "record_heartbeat"):
            self._forward("record_heartbeat", trial_id)

    def _get_stale_trial_ids(self, study_id: int) -> list[int]:
        if hasattr(self._backend, "_get_stale_trial_ids"):
            return self._forward("_get_stale_trial_ids", study_id)
        return []

    def get_heartbeat_interval(self) -> int | None:
        if hasattr(self._backend, "get_heartbeat_interval"):
            return self._forward("get_heartbeat_interval")
        return None

    def get_failed_trial_callback(self) -> Any:
        if hasattr(self._backend, "get_failed_trial_callback"):
            return self._forward("get_failed_trial_callback")
        return None

    # -------------------------------------------------------------- lifecycle

    def remove_session(self) -> None:
        self._backend.remove_session()


from optuna_tpu_torch.study._frozen import FrozenStudy  # noqa: E402  (cycle-breaking tail import)
