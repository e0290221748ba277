"""Operation-sourced storage: append ops, replay into in-memory state (port
of ``optuna_tpu/storages/journal/_storage.py``).

Parity target: ``optuna/storages/journal/_storage.py`` — 10-op enum
(``:40-51``), append + replay sync (``_sync_with_backend:147``), worker-id
prefixes for op ownership, pickle snapshots every 100 studies (``:37``).

Every mutation appends one JSON op and then replays the tail of the log, so
all workers sharing the backend converge on the same state; CAS semantics
(WAITING->RUNNING claims, finished-trial protection) are resolved *during
replay* and reported back to the issuing worker through an own-op result map.
The log format is the reference's: a log written by either package
replays in the other (snapshots excepted: they pickle package classes).

Loops keep their replicated state in study *system attrs* on top of this
log, under reserved key namespaces such as ``ckpt:`` (the checkpoint ring,
:mod:`optuna_tpu_torch.checkpoint`). The journal itself treats these as
opaque attrs.
"""

from __future__ import annotations

import datetime
import enum
import os
import pickle
import threading
import uuid
from typing import Any, Container, Sequence

from optuna_tpu_torch.distributions import (
    BaseDistribution,
    check_distribution_compatibility,
    distribution_to_json,
    json_to_distribution,
)
from optuna_tpu_torch import telemetry
from optuna_tpu_torch.exceptions import DuplicatedStudyError, UpdateFinishedTrialError
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages._base import DEFAULT_STUDY_NAME_PREFIX, BaseStorage
from optuna_tpu_torch.storages.journal._base import BaseJournalBackend
from optuna_tpu_torch.study._frozen import FrozenStudy
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

_logger = get_logger(__name__)

SNAPSHOT_INTERVAL = 100


class JournalOperation(enum.IntEnum):
    CREATE_STUDY = 0
    DELETE_STUDY = 1
    SET_STUDY_USER_ATTR = 2
    SET_STUDY_SYSTEM_ATTR = 3
    CREATE_TRIAL = 4
    SET_TRIAL_PARAM = 5
    SET_TRIAL_STATE_VALUES = 6
    SET_TRIAL_INTERMEDIATE_VALUE = 7
    SET_TRIAL_USER_ATTR = 8
    SET_TRIAL_SYSTEM_ATTR = 9


class _StudyState:
    def __init__(self, study_id: int, name: str, directions: list[int]) -> None:
        self.study_id = study_id
        self.name = name
        self.directions = directions
        self.user_attrs: dict[str, Any] = {}
        self.system_attrs: dict[str, Any] = {}
        self.trials: list[FrozenTrial] = []


class _ReplayResult:
    """The deterministic state machine every worker replays.

    Allocation order is part of the replay contract: ``next_study_id`` /
    ``next_trial_id`` advance monotonically in merged-log order, so any
    worker that has replayed an op stream can derive what ids a peer's
    creates were assigned without having issued them. The pod follower
    (``parallel.sharded.PodFollowerStorage``) leans on exactly this: it
    mirrors the leader's writes by syncing the merged journal and reading
    the newest ids/states off this replay state.
    """

    def __init__(self) -> None:
        self.log_number_read = 0
        self.studies: dict[int, _StudyState] = {}
        self.study_name_to_id: dict[str, int] = {}
        self.next_study_id = 0
        self.trial_id_to_study_and_number: dict[int, tuple[int, int]] = {}
        self.next_trial_id = 0
        self.n_studies_created = 0
        # (worker_id, issue_id) -> result for ops issued by THIS process.
        self.own_results: dict[tuple[str, int], Any] = {}

    # -------------------------------------------------------------- op apply

    def apply(self, op: dict[str, Any], own_worker_id: str) -> None:
        code = JournalOperation(op["op"])
        handler = getattr(self, f"_apply_{code.name.lower()}")
        result = handler(op)
        if op.get("wid") == own_worker_id:
            self.own_results[(op["wid"], op["iid"])] = result

    def _trial(self, trial_id: int) -> FrozenTrial | None:
        loc = self.trial_id_to_study_and_number.get(trial_id)
        if loc is None:
            return None
        study_id, number = loc
        study = self.studies.get(study_id)
        if study is None:
            return None
        return study.trials[number]

    def _apply_create_study(self, op: dict[str, Any]) -> Any:
        name = op["study_name"]
        if name in self.study_name_to_id:
            return DuplicatedStudyError(f"Another study with name '{name}' already exists.")
        study_id = self.next_study_id
        self.next_study_id += 1
        self.studies[study_id] = _StudyState(study_id, name, op["directions"])
        self.study_name_to_id[name] = study_id
        self.n_studies_created += 1
        return study_id

    def _apply_delete_study(self, op: dict[str, Any]) -> Any:
        study_id = op["study_id"]
        study = self.studies.pop(study_id, None)
        if study is None:
            return KeyError(f"No study with study_id {study_id} exists.")
        del self.study_name_to_id[study.name]
        for t in study.trials:
            self.trial_id_to_study_and_number.pop(t._trial_id, None)
        return None

    def _apply_set_study_user_attr(self, op: dict[str, Any]) -> Any:
        study = self.studies.get(op["study_id"])
        if study is None:
            return KeyError(f"No study with study_id {op['study_id']} exists.")
        study.user_attrs[op["key"]] = op["value"]
        return None

    def _apply_set_study_system_attr(self, op: dict[str, Any]) -> Any:
        study = self.studies.get(op["study_id"])
        if study is None:
            return KeyError(f"No study with study_id {op['study_id']} exists.")
        study.system_attrs[op["key"]] = op["value"]
        return None

    def _apply_create_trial(self, op: dict[str, Any]) -> Any:
        study = self.studies.get(op["study_id"])
        if study is None:
            return KeyError(f"No study with study_id {op['study_id']} exists.")
        trial_id = self.next_trial_id
        self.next_trial_id += 1
        number = len(study.trials)
        t = op.get("template")
        if t is None:
            trial = FrozenTrial(
                number=number,
                trial_id=trial_id,
                state=TrialState.RUNNING,
                value=None,
                datetime_start=_parse_dt(op.get("datetime_start")),
                datetime_complete=None,
                params={},
                distributions={},
                user_attrs={},
                system_attrs={},
                intermediate_values={},
            )
        else:
            trial = _trial_from_json(t, number, trial_id)
        study.trials.append(trial)
        self.trial_id_to_study_and_number[trial_id] = (op["study_id"], number)
        return trial_id

    def _apply_set_trial_param(self, op: dict[str, Any]) -> Any:
        trial = self._trial(op["trial_id"])
        if trial is None:
            return KeyError(f"No trial with trial_id {op['trial_id']} exists.")
        if trial.state.is_finished():
            return UpdateFinishedTrialError(
                f"Trial#{trial.number} has already finished and can not be updated."
            )
        distribution = json_to_distribution(op["distribution"])
        if op["param_name"] in trial._distributions:
            try:
                check_distribution_compatibility(
                    trial._distributions[op["param_name"]], distribution
                )
            except ValueError as e:
                return e
        trial.params = {
            **trial.params,
            op["param_name"]: distribution.to_external_repr(op["param_value_internal"]),
        }
        trial._distributions = {**trial._distributions, op["param_name"]: distribution}
        return None

    def _apply_set_trial_state_values(self, op: dict[str, Any]) -> Any:
        trial = self._trial(op["trial_id"])
        if trial is None:
            return KeyError(f"No trial with trial_id {op['trial_id']} exists.")
        if trial.state.is_finished():
            return UpdateFinishedTrialError(
                f"Trial#{trial.number} has already finished and can not be updated."
            )
        state = TrialState(op["state"])
        if state == TrialState.RUNNING and trial.state != TrialState.WAITING:
            return False  # lost the claim CAS
        trial.state = state
        if op.get("values") is not None:
            trial.values = op["values"]
        if state == TrialState.RUNNING:
            trial.datetime_start = _parse_dt(op.get("datetime"))
        if state.is_finished():
            trial.datetime_complete = _parse_dt(op.get("datetime"))
        return True

    def _apply_set_trial_intermediate_value(self, op: dict[str, Any]) -> Any:
        trial = self._trial(op["trial_id"])
        if trial is None:
            return KeyError(f"No trial with trial_id {op['trial_id']} exists.")
        if trial.state.is_finished():
            return UpdateFinishedTrialError(
                f"Trial#{trial.number} has already finished and can not be updated."
            )
        trial.intermediate_values = {
            **trial.intermediate_values,
            int(op["step"]): op["intermediate_value"],
        }
        return None

    def _apply_set_trial_user_attr(self, op: dict[str, Any]) -> Any:
        trial = self._trial(op["trial_id"])
        if trial is None:
            return KeyError(f"No trial with trial_id {op['trial_id']} exists.")
        if trial.state.is_finished():
            return UpdateFinishedTrialError(
                f"Trial#{trial.number} has already finished and can not be updated."
            )
        trial.user_attrs = {**trial.user_attrs, op["key"]: op["value"]}
        return None

    def _apply_set_trial_system_attr(self, op: dict[str, Any]) -> Any:
        trial = self._trial(op["trial_id"])
        if trial is None:
            return KeyError(f"No trial with trial_id {op['trial_id']} exists.")
        if trial.state.is_finished():
            return UpdateFinishedTrialError(
                f"Trial#{trial.number} has already finished and can not be updated."
            )
        trial.system_attrs = {**trial.system_attrs, op["key"]: op["value"]}
        return None


def _dt_str(dt: datetime.datetime | None) -> str | None:
    return None if dt is None else dt.isoformat()


def _parse_dt(s: str | None) -> datetime.datetime | None:
    return None if s is None else datetime.datetime.fromisoformat(s)


def _trial_to_json(trial: FrozenTrial) -> dict[str, Any]:
    return {
        "state": int(trial.state),
        "values": trial.values,
        "datetime_start": _dt_str(trial.datetime_start),
        "datetime_complete": _dt_str(trial.datetime_complete),
        "params": {
            k: trial.distributions[k].to_internal_repr(v) for k, v in trial.params.items()
        },
        "distributions": {
            k: distribution_to_json(d) for k, d in trial.distributions.items()
        },
        "user_attrs": trial.user_attrs,
        "system_attrs": trial.system_attrs,
        "intermediate_values": {str(k): v for k, v in trial.intermediate_values.items()},
    }


def _trial_from_json(t: dict[str, Any], number: int, trial_id: int) -> FrozenTrial:
    distributions = {k: json_to_distribution(d) for k, d in t["distributions"].items()}
    params = {
        k: distributions[k].to_external_repr(v) for k, v in t["params"].items()
    }
    return FrozenTrial(
        number=number,
        trial_id=trial_id,
        state=TrialState(t["state"]),
        value=None,
        values=t.get("values"),
        datetime_start=_parse_dt(t.get("datetime_start")),
        datetime_complete=_parse_dt(t.get("datetime_complete")),
        params=params,
        distributions=distributions,
        user_attrs=t.get("user_attrs", {}),
        system_attrs=t.get("system_attrs", {}),
        intermediate_values={int(k): v for k, v in t.get("intermediate_values", {}).items()},
    )


class JournalStorage(BaseStorage):
    """Storage over any :class:`BaseJournalBackend`."""

    def __init__(self, log_storage: BaseJournalBackend) -> None:
        self._backend = log_storage
        self._worker_id = f"{uuid.uuid4().hex}-{os.getpid()}"
        self._issue_counter = 0
        self._thread_lock = threading.RLock()
        self._replay = _ReplayResult()
        snapshot = self._backend.load_snapshot()
        if snapshot is not None:
            # Byte integrity is the backend's job now: load_snapshot verifies
            # a CRC32 header (journal/_file.py::unframe_snapshot) and reports
            # torn/corrupt/legacy snapshots as None. That shrinks the
            # once-broad except (corrupt bytes raise OverflowError /
            # MemoryError / arbitrary __setstate__ errors) to the honest
            # version-drift survivors: UnpicklingError for protocol/opcode
            # mismatch, AttributeError/ImportError for a checksum-valid
            # snapshot written by a release whose classes moved or changed
            # shape. Full replay stays the fallback either way.
            try:
                restored = pickle.loads(snapshot)
                if isinstance(restored, _ReplayResult):
                    self._replay = restored
                    self._replay.own_results = {}
            except (pickle.UnpicklingError, AttributeError, ImportError) as err:
                telemetry.count("journal.snapshot_rejected")
                _logger.warning(
                    f"Journal snapshot passed its CRC but failed to unpickle "
                    f"({type(err).__name__}: {err}); likely written by a "
                    "different release. Replaying the journal from its logs "
                    "instead."
                )
        self._sync()

    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        del state["_thread_lock"]
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.__dict__.update(state)
        # A forked/unpickled copy is a new worker with its own op stream.
        self._worker_id = f"{uuid.uuid4().hex}-{os.getpid()}"
        self._issue_counter = 0
        self._thread_lock = threading.RLock()

    # -------------------------------------------------------------- plumbing

    def _sync(self) -> None:
        logs = self._backend.read_logs(self._replay.log_number_read)
        for op in logs:
            self._replay.apply(op, self._worker_id)
            self._replay.log_number_read += 1

    def _enqueue(self, op_code: JournalOperation, payload: dict[str, Any]) -> Any:
        """Append one op, replay, and surface this op's replay result."""
        with self._thread_lock:
            self._issue_counter += 1
            iid = self._issue_counter
            op = {"op": int(op_code), "wid": self._worker_id, "iid": iid, **payload}
            self._backend.append_logs([op])
            self._sync()
            result = self._replay.own_results.pop((self._worker_id, iid), None)
            if isinstance(result, Exception):
                raise result
            return result

    def _maybe_snapshot(self) -> None:
        if (
            self._replay.n_studies_created > 0
            and self._replay.n_studies_created % SNAPSHOT_INTERVAL == 0
        ):
            own = self._replay.own_results
            self._replay.own_results = {}
            try:
                self._backend.save_snapshot(pickle.dumps(self._replay))
            finally:
                self._replay.own_results = own

    # ----------------------------------------------------------------- study

    def create_new_study(
        self, directions: Sequence[StudyDirection], study_name: str | None = None
    ) -> int:
        study_name = study_name or DEFAULT_STUDY_NAME_PREFIX + str(uuid.uuid4())
        study_id = self._enqueue(
            JournalOperation.CREATE_STUDY,
            {"study_name": study_name, "directions": [int(d) for d in directions]},
        )
        self._maybe_snapshot()
        return study_id

    def delete_study(self, study_id: int) -> None:
        self._enqueue(JournalOperation.DELETE_STUDY, {"study_id": study_id})

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        self._enqueue(
            JournalOperation.SET_STUDY_USER_ATTR,
            {"study_id": study_id, "key": key, "value": value},
        )

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        self._enqueue(
            JournalOperation.SET_STUDY_SYSTEM_ATTR,
            {"study_id": study_id, "key": key, "value": value},
        )

    def get_study_id_from_name(self, study_name: str) -> int:
        with self._thread_lock:
            self._sync()
            if study_name not in self._replay.study_name_to_id:
                raise KeyError(f"No such study {study_name}.")
            return self._replay.study_name_to_id[study_name]

    def get_study_name_from_id(self, study_id: int) -> str:
        with self._thread_lock:
            self._sync()
            return self._study(study_id).name

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        with self._thread_lock:
            self._sync()
            return [StudyDirection(d) for d in self._study(study_id).directions]

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        with self._thread_lock:
            self._sync()
            return dict(self._study(study_id).user_attrs)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        with self._thread_lock:
            self._sync()
            return dict(self._study(study_id).system_attrs)

    def get_all_studies(self) -> list[FrozenStudy]:
        with self._thread_lock:
            self._sync()
            return [
                FrozenStudy(
                    study_name=s.name,
                    direction=None,
                    directions=[StudyDirection(d) for d in s.directions],
                    user_attrs=dict(s.user_attrs),
                    system_attrs=dict(s.system_attrs),
                    study_id=sid,
                )
                for sid, s in self._replay.studies.items()
            ]

    def _study(self, study_id: int) -> _StudyState:
        study = self._replay.studies.get(study_id)
        if study is None:
            raise KeyError(f"No study with study_id {study_id} exists.")
        return study

    # ----------------------------------------------------------------- trial

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        payload: dict[str, Any] = {
            "study_id": study_id,
            "datetime_start": _dt_str(datetime.datetime.now()),
        }
        if template_trial is not None:
            payload["template"] = _trial_to_json(template_trial)
        return self._enqueue(JournalOperation.CREATE_TRIAL, payload)

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        """Batch create: ONE backend append (one lock/fsync/exchange round)
        carries all n CREATE_TRIAL ops."""
        if n <= 0:
            return []
        template_json = None if template_trial is None else _trial_to_json(template_trial)
        with self._thread_lock:
            ops = []
            iids = []
            for _ in range(n):
                self._issue_counter += 1
                iids.append(self._issue_counter)
                payload: dict[str, Any] = {
                    "study_id": study_id,
                    "datetime_start": _dt_str(datetime.datetime.now()),
                }
                if template_json is not None:
                    payload["template"] = template_json
                ops.append(
                    {
                        "op": int(JournalOperation.CREATE_TRIAL),
                        "wid": self._worker_id,
                        "iid": iids[-1],
                        **payload,
                    }
                )
            self._backend.append_logs(ops)
            self._sync()
            out: list[int] = []
            for iid in iids:
                result = self._replay.own_results.pop((self._worker_id, iid), None)
                if isinstance(result, Exception):
                    raise result
                out.append(result)
            return out

    def set_trial_param(
        self,
        trial_id: int,
        param_name: str,
        param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        self._enqueue(
            JournalOperation.SET_TRIAL_PARAM,
            {
                "trial_id": trial_id,
                "param_name": param_name,
                "param_value_internal": param_value_internal,
                "distribution": distribution_to_json(distribution),
            },
        )

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Sequence[float] | None = None
    ) -> bool:
        result = self._enqueue(
            JournalOperation.SET_TRIAL_STATE_VALUES,
            {
                "trial_id": trial_id,
                "state": int(state),
                "values": None if values is None else [float(v) for v in values],
                "datetime": _dt_str(datetime.datetime.now()),
            },
        )
        return bool(result)

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        self._enqueue(
            JournalOperation.SET_TRIAL_INTERMEDIATE_VALUE,
            {"trial_id": trial_id, "step": step, "intermediate_value": intermediate_value},
        )

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._enqueue(
            JournalOperation.SET_TRIAL_USER_ATTR,
            {"trial_id": trial_id, "key": key, "value": value},
        )

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._enqueue(
            JournalOperation.SET_TRIAL_SYSTEM_ATTR,
            {"trial_id": trial_id, "key": key, "value": value},
        )

    def get_trial(self, trial_id: int) -> FrozenTrial:
        with self._thread_lock:
            self._sync()
            trial = self._replay._trial(trial_id)
            if trial is None:
                raise KeyError(f"No trial with trial_id {trial_id} exists.")
            import copy

            return copy.deepcopy(trial) if not trial.state.is_finished() else trial

    def get_all_trials(
        self,
        study_id: int,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
    ) -> list[FrozenTrial]:
        import copy

        with self._thread_lock:
            self._sync()
            trials = self._study(study_id).trials
            if states is not None:
                trials = [t for t in trials if t.state in states]
            return copy.deepcopy(list(trials)) if deepcopy else list(trials)
