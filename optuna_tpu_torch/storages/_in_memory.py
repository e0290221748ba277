"""Single-process in-memory storage (reference ``optuna/storages/_in_memory.py:26``).

Dict-of-studies guarded by one ``threading.RLock``; safe for ``n_jobs``
thread fan-out. Finished trials are immutable, so non-deepcopy reads hand out
shared references (the perf-critical path for samplers re-reading history
every trial).
"""

from __future__ import annotations

import copy
import datetime
import threading
import uuid
from typing import Any, Container, Sequence

from optuna_tpu_torch.distributions import BaseDistribution, check_distribution_compatibility
from optuna_tpu_torch.exceptions import DuplicatedStudyError, UpdateFinishedTrialError
from optuna_tpu_torch.storages._base import DEFAULT_STUDY_NAME_PREFIX, BaseStorage
from optuna_tpu_torch.study._frozen import FrozenStudy
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState


class _StudyInfo:
    def __init__(self, name: str, directions: list[StudyDirection]) -> None:
        self.name = name
        self.directions = directions
        self.user_attrs: dict[str, Any] = {}
        self.system_attrs: dict[str, Any] = {}
        self.trials: list[FrozenTrial] = []
        self.best_trial_id: int | None = None


class InMemoryStorage(BaseStorage):
    """Thread-safe dict storage; trial_id is globally dense across studies."""

    def __init__(self) -> None:
        self._studies: dict[int, _StudyInfo] = {}
        self._study_name_to_id: dict[str, int] = {}
        self._max_study_id = -1
        self._max_trial_id = -1  # monotonic: ids survive delete_study
        self._trial_id_to_study_id_and_number: dict[int, tuple[int, int]] = {}
        self._lock = threading.RLock()

    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ study

    def create_new_study(
        self, directions: Sequence[StudyDirection], study_name: str | None = None
    ) -> int:
        with self._lock:
            study_id = self._max_study_id + 1
            if study_name is not None:
                if study_name in self._study_name_to_id:
                    raise DuplicatedStudyError(
                        f"Another study with name '{study_name}' already exists."
                    )
            else:
                study_name = DEFAULT_STUDY_NAME_PREFIX + str(uuid.uuid4())
            self._max_study_id = study_id
            self._studies[study_id] = _StudyInfo(study_name, list(directions))
            self._study_name_to_id[study_name] = study_id
            return study_id

    def delete_study(self, study_id: int) -> None:
        with self._lock:
            self._check_study_id(study_id)
            for trial in self._studies[study_id].trials:
                del self._trial_id_to_study_id_and_number[trial._trial_id]
            study_name = self._studies[study_id].name
            del self._study_name_to_id[study_name]
            del self._studies[study_id]

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        with self._lock:
            self._check_study_id(study_id)
            self._studies[study_id].user_attrs[key] = value

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        with self._lock:
            self._check_study_id(study_id)
            self._studies[study_id].system_attrs[key] = value

    def get_study_id_from_name(self, study_name: str) -> int:
        with self._lock:
            if study_name not in self._study_name_to_id:
                raise KeyError(f"No such study {study_name}.")
            return self._study_name_to_id[study_name]

    def get_study_name_from_id(self, study_id: int) -> str:
        with self._lock:
            self._check_study_id(study_id)
            return self._studies[study_id].name

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        with self._lock:
            self._check_study_id(study_id)
            return self._studies[study_id].directions

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        with self._lock:
            self._check_study_id(study_id)
            return self._studies[study_id].user_attrs

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        with self._lock:
            self._check_study_id(study_id)
            return self._studies[study_id].system_attrs

    def get_all_studies(self) -> list[FrozenStudy]:
        with self._lock:
            return [
                FrozenStudy(
                    study_name=info.name,
                    direction=None,
                    directions=info.directions,
                    user_attrs=copy.deepcopy(info.user_attrs),
                    system_attrs=copy.deepcopy(info.system_attrs),
                    study_id=study_id,
                )
                for study_id, info in self._studies.items()
            ]

    # ------------------------------------------------------------------ trial

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        with self._lock:
            self._check_study_id(study_id)
            study = self._studies[study_id]
            if template_trial is None:
                trial = FrozenTrial(
                    number=-1,
                    trial_id=-1,
                    state=TrialState.RUNNING,
                    value=None,
                    datetime_start=datetime.datetime.now(),
                    datetime_complete=None,
                    params={},
                    distributions={},
                    user_attrs={},
                    system_attrs={},
                    intermediate_values={},
                )
            else:
                trial = copy.deepcopy(template_trial)
            self._max_trial_id += 1
            trial_id = self._max_trial_id
            number = len(study.trials)
            trial._trial_id = trial_id
            trial.number = number
            self._trial_id_to_study_id_and_number[trial_id] = (study_id, number)
            study.trials.append(trial)
            self._update_cache(trial_id, study_id)
            return trial_id

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        # One lock acquisition for the whole batch.
        with self._lock:
            return [self.create_new_trial(study_id, template_trial) for _ in range(n)]

    def _get_trial_mutable(self, trial_id: int) -> tuple[FrozenTrial, int]:
        if trial_id not in self._trial_id_to_study_id_and_number:
            raise KeyError(f"No trial with trial_id {trial_id} exists.")
        study_id, number = self._trial_id_to_study_id_and_number[trial_id]
        return self._studies[study_id].trials[number], study_id

    def _check_trial_is_updatable(self, trial: FrozenTrial) -> None:
        if trial.state.is_finished():
            raise UpdateFinishedTrialError(
                f"Trial#{trial.number} has already finished and can not be updated."
            )

    def set_trial_param(
        self,
        trial_id: int,
        param_name: str,
        param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        with self._lock:
            trial, _ = self._get_trial_mutable(trial_id)
            self._check_trial_is_updatable(trial)
            if param_name in trial._distributions:
                check_distribution_compatibility(trial._distributions[param_name], distribution)
            # Copy-on-write so snapshots handed out earlier stay stable.
            params = trial.params.copy()
            dists = trial._distributions.copy()
            params[param_name] = distribution.to_external_repr(param_value_internal)
            dists[param_name] = distribution
            trial.params = params
            trial._distributions = dists

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Sequence[float] | None = None
    ) -> bool:
        with self._lock:
            trial, study_id = self._get_trial_mutable(trial_id)
            self._check_trial_is_updatable(trial)
            if state == TrialState.RUNNING and trial.state != TrialState.WAITING:
                return False  # lost the WAITING->RUNNING CAS
            trial.state = state
            if values is not None:
                trial.values = list(values)
            if state == TrialState.RUNNING:
                trial.datetime_start = datetime.datetime.now()
            if state.is_finished():
                trial.datetime_complete = datetime.datetime.now()
                self._update_cache(trial_id, study_id)
            return True

    def _update_cache(self, trial_id: int, study_id: int) -> None:
        # Maintain best_trial_id incrementally (single-objective only).
        study = self._studies[study_id]
        if len(study.directions) > 1:
            return
        trial, _ = self._get_trial_mutable(trial_id)
        if trial.state != TrialState.COMPLETE or trial.value is None:
            return
        if study.best_trial_id is None:
            study.best_trial_id = trial_id
            return
        best, _ = self._get_trial_mutable(study.best_trial_id)
        assert best.value is not None
        if study.directions[0] == StudyDirection.MAXIMIZE:
            if trial.value > best.value:
                study.best_trial_id = trial_id
        elif trial.value < best.value:
            study.best_trial_id = trial_id

    def get_best_trial(self, study_id: int) -> FrozenTrial:
        with self._lock:
            self._check_study_id(study_id)
            if len(self._studies[study_id].directions) > 1:
                return super().get_best_trial(study_id)
            best_id = self._studies[study_id].best_trial_id
            if best_id is None:
                raise ValueError("No trials are completed yet.")
            return self.get_trial(best_id)

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        with self._lock:
            trial, _ = self._get_trial_mutable(trial_id)
            self._check_trial_is_updatable(trial)
            values = trial.intermediate_values.copy()
            values[step] = intermediate_value
            trial.intermediate_values = values

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        with self._lock:
            trial, _ = self._get_trial_mutable(trial_id)
            self._check_trial_is_updatable(trial)
            attrs = trial.user_attrs.copy()
            attrs[key] = value
            trial.user_attrs = attrs

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        with self._lock:
            trial, _ = self._get_trial_mutable(trial_id)
            self._check_trial_is_updatable(trial)
            attrs = trial.system_attrs.copy()
            attrs[key] = value
            trial.system_attrs = attrs

    def get_trial(self, trial_id: int) -> FrozenTrial:
        with self._lock:
            trial, _ = self._get_trial_mutable(trial_id)
            return trial._structural_copy() if not trial.state.is_finished() else trial

    def get_all_trials(
        self,
        study_id: int,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
    ) -> list[FrozenTrial]:
        with self._lock:
            self._check_study_id(study_id)
            trials = self._studies[study_id].trials
            if states is not None:
                trials = [t for t in trials if t.state in states]
            if deepcopy:
                return copy.deepcopy(trials)
            return list(trials)

    def get_n_trials(
        self, study_id: int, state: tuple[TrialState, ...] | TrialState | None = None
    ) -> int:
        if isinstance(state, TrialState):
            state = (state,)
        with self._lock:
            self._check_study_id(study_id)
            if state is None:
                return len(self._studies[study_id].trials)
            return sum(1 for t in self._studies[study_id].trials if t.state in state)

    def _check_study_id(self, study_id: int) -> None:
        if study_id not in self._studies:
            raise KeyError(f"No study with study_id {study_id} exists.")
