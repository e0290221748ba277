"""Per-process read cache over a remote-ish storage (port of
``optuna_tpu/storages/_cached_storage.py``): ``get_storage`` wraps the RDB
storage in it, and it wraps any other storage too.

Parity target: ``optuna/storages/_cached_storage.py:22-36`` — finished trials
are immutable, so they are cached forever; unfinished trial ids are tracked
and re-read on access; all writes delegate to the backend. Reads go through
the backend's ``_read_trials_partial`` watermark API, so a wrapped gRPC
proxy polls only *new* trials over the wire.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Container, Sequence

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.storages._base import BaseStorage
from optuna_tpu_torch.storages._heartbeat import BaseHeartbeat
from optuna_tpu_torch.study._frozen import FrozenStudy
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState


class _StudyCache:
    def __init__(self) -> None:
        self.finished_trials: dict[int, FrozenTrial] = {}  # trial_id -> trial
        self.unfinished_trial_ids: set[int] = set()


class _CachedStorage(BaseStorage, BaseHeartbeat):
    def __init__(self, backend: BaseStorage) -> None:
        self._backend = backend
        self._studies: dict[int, _StudyCache] = {}
        self._lock = threading.Lock()

    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    # --------------------------------------------------- study (pass-through)

    def create_new_study(
        self, directions: Sequence[StudyDirection], study_name: str | None = None
    ) -> int:
        study_id = self._backend.create_new_study(directions, study_name)
        with self._lock:
            self._studies[study_id] = _StudyCache()
        return study_id

    def delete_study(self, study_id: int) -> None:
        with self._lock:
            self._studies.pop(study_id, None)
        self._backend.delete_study(study_id)

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        self._backend.set_study_user_attr(study_id, key, value)

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        self._backend.set_study_system_attr(study_id, key, value)

    def get_study_id_from_name(self, study_name: str) -> int:
        return self._backend.get_study_id_from_name(study_name)

    def get_study_name_from_id(self, study_id: int) -> str:
        return self._backend.get_study_name_from_id(study_id)

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        return self._backend.get_study_directions(study_id)

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        return self._backend.get_study_user_attrs(study_id)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        return self._backend.get_study_system_attrs(study_id)

    def get_all_studies(self) -> list[FrozenStudy]:
        return self._backend.get_all_studies()

    # ------------------------------------------------------------------ trial

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        trial_id = self._backend.create_new_trial(study_id, template_trial)
        with self._lock:
            cache = self._studies.setdefault(study_id, _StudyCache())
            cache.unfinished_trial_ids.add(trial_id)
        return trial_id

    def set_trial_param(
        self,
        trial_id: int,
        param_name: str,
        param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        self._backend.set_trial_param(trial_id, param_name, param_value_internal, distribution)

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Sequence[float] | None = None
    ) -> bool:
        return self._backend.set_trial_state_values(trial_id, state, values)

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        self._backend.set_trial_intermediate_value(trial_id, step, intermediate_value)

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._backend.set_trial_user_attr(trial_id, key, value)

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._backend.set_trial_system_attr(trial_id, key, value)

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        trial_ids = self._backend.create_new_trials(study_id, n, template_trial)
        # Same cache registration as the single-create path: track as
        # unfinished so refresh reads include them regardless of watermark.
        with self._lock:
            cache = self._studies.setdefault(study_id, _StudyCache())
            cache.unfinished_trial_ids.update(trial_ids)
        return trial_ids

    def get_trial(self, trial_id: int) -> FrozenTrial:
        with self._lock:
            for cache in self._studies.values():
                if trial_id in cache.finished_trials:
                    return cache.finished_trials[trial_id]
        # Do NOT insert into finished_trials here: get_all_trials uses
        # max(finished ids) as its contiguous-read watermark, and a stray
        # high id cached out of order would hide other workers' older trials.
        return self._backend.get_trial(trial_id)

    def get_all_trials(
        self,
        study_id: int,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
    ) -> list[FrozenTrial]:
        # Only unfinished and unseen trials hit the database; finished trials
        # come from the immutable cache (the point of this wrapper: sampler
        # history reads stop being O(n) SQL work).
        with self._lock:
            cache = self._studies.setdefault(study_id, _StudyCache())
            known_finished = dict(cache.finished_trials)
            refresh_ids = set(cache.unfinished_trial_ids)
        max_known = max(known_finished, default=-1)
        fresh = self._backend._read_trials_partial(study_id, max_known, refresh_ids)
        with self._lock:
            for t in fresh:
                if t.state.is_finished():
                    cache.finished_trials[t._trial_id] = t
                    cache.unfinished_trial_ids.discard(t._trial_id)
                else:
                    cache.unfinished_trial_ids.add(t._trial_id)
        merged_map = {**known_finished, **{t._trial_id: t for t in fresh}}
        merged = [merged_map[k] for k in sorted(merged_map)]
        if states is not None:
            merged = [t for t in merged if t.state in states]
        return copy.deepcopy(merged) if deepcopy else merged

    # -------------------------------------------------------------- heartbeat
    # Delegated when the backend has heartbeats; "heartbeat disabled"
    # otherwise, as ``_ForwardingStorage`` does. The reference wraps only
    # heartbeat backends (RDB, gRPC); the port also wraps backends without
    # heartbeats, such as ``InMemoryStorage``.

    def record_heartbeat(self, trial_id: int) -> None:
        if hasattr(self._backend, "record_heartbeat"):
            self._backend.record_heartbeat(trial_id)

    def _get_stale_trial_ids(self, study_id: int) -> list[int]:
        if hasattr(self._backend, "_get_stale_trial_ids"):
            return self._backend._get_stale_trial_ids(study_id)
        return []

    def get_heartbeat_interval(self) -> int | None:
        if hasattr(self._backend, "get_heartbeat_interval"):
            return self._backend.get_heartbeat_interval()
        return None

    def get_failed_trial_callback(self) -> Callable | None:
        if hasattr(self._backend, "get_failed_trial_callback"):
            return self._backend.get_failed_trial_callback()
        return None

    def remove_session(self) -> None:
        self._backend.remove_session()
