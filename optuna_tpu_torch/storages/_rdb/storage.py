"""Relational storage on stdlib sqlite3 (port of
``optuna_tpu/storages/_rdb/storage.py``).

Parity target: ``optuna/storages/_rdb/`` — the same 11-table layout
(``models.py``: studies:55, study_directions:92, attr tables:109-327,
trials:173, trial_params:359, trial_values:408 with +/-inf encoding:414-463,
intermediate_values:471, trial_heartbeats:537, version_info:560), schema
versioning/migration (alembic there, ``PRAGMA user_version`` here), heartbeat
queries (``storage.py:1041-1054``) and the WAITING->RUNNING claim CAS.

Differences by design: the reference rides SQLAlchemy + C database drivers;
this implementation writes one canonical SQL flavor (SQLite's) against
per-thread DBAPI connections — no ORM layer. Server databases
(mysql/postgres) are supported through the explicit dialect layer in
``_dialect.py`` (paramstyle, upserts, DDL types, ``FOR UPDATE`` row locks,
connection pre-ping), resolved lazily so sqlite-only deployments never
import a driver.
"""

from __future__ import annotations

import datetime
import json
import sqlite3
import threading
import time
from typing import Any, Callable, Container, Sequence

from optuna_tpu_torch.distributions import (
    BaseDistribution,
    check_distribution_compatibility,
    distribution_to_json,
    json_to_distribution,
)
from optuna_tpu_torch.exceptions import DuplicatedStudyError, UpdateFinishedTrialError
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages._base import DEFAULT_STUDY_NAME_PREFIX, BaseStorage
from optuna_tpu_torch.storages._heartbeat import BaseHeartbeat
from optuna_tpu_torch.storages._rdb._dialect import make_dialect
from optuna_tpu_torch.study._frozen import FrozenStudy
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

_logger = get_logger(__name__)

SCHEMA_VERSION = 2

# Fresh databases are created directly at the head schema below. Databases
# written by older versions are carried forward through _MIGRATIONS — one
# ordered SQL batch per (from_version -> from_version+1) step, the stdlib
# analogue of the reference's alembic chain
# (optuna/storages/_rdb/alembic/versions/, storage.py:1021-1039).
_MIGRATIONS: dict[int, list[str]] = {
    1: [
        # v2: study creation timestamps + a covering index for the hot
        # "trials of study S in state X" scan (claim CAS, get_all_trials).
        "ALTER TABLE studies ADD COLUMN created_at TEXT",
        "CREATE INDEX IF NOT EXISTS ix_trials_study_state"
        " ON trials(study_id, state)",
    ],
}

# DDL template: {autopk}/{skey}/{float} are filled per dialect
# (_dialect.ddl_types) — e.g. AUTOINCREMENT vs AUTO_INCREMENT vs SERIAL,
# TEXT vs VARCHAR(512) for MySQL's indexed-key length limit.
_SCHEMA = """
CREATE TABLE IF NOT EXISTS studies (
    study_id {autopk},
    study_name {skey} NOT NULL UNIQUE,
    created_at TEXT
);
CREATE TABLE IF NOT EXISTS study_directions (
    study_id INTEGER NOT NULL REFERENCES studies(study_id) ON DELETE CASCADE,
    objective INTEGER NOT NULL,
    direction INTEGER NOT NULL,
    PRIMARY KEY (study_id, objective)
);
CREATE TABLE IF NOT EXISTS study_user_attributes (
    study_id INTEGER NOT NULL REFERENCES studies(study_id) ON DELETE CASCADE,
    key {skey} NOT NULL,
    value_json TEXT,
    PRIMARY KEY (study_id, key)
);
CREATE TABLE IF NOT EXISTS study_system_attributes (
    study_id INTEGER NOT NULL REFERENCES studies(study_id) ON DELETE CASCADE,
    key {skey} NOT NULL,
    value_json TEXT,
    PRIMARY KEY (study_id, key)
);
CREATE TABLE IF NOT EXISTS trials (
    trial_id {autopk},
    number INTEGER NOT NULL,
    study_id INTEGER NOT NULL REFERENCES studies(study_id) ON DELETE CASCADE,
    state INTEGER NOT NULL,
    datetime_start TEXT,
    datetime_complete TEXT
);
CREATE INDEX IF NOT EXISTS ix_trials_study_id ON trials(study_id);
CREATE INDEX IF NOT EXISTS ix_trials_study_state ON trials(study_id, state);
CREATE TABLE IF NOT EXISTS trial_params (
    trial_id INTEGER NOT NULL REFERENCES trials(trial_id) ON DELETE CASCADE,
    param_name {skey} NOT NULL,
    param_value {float},
    distribution_json TEXT NOT NULL,
    PRIMARY KEY (trial_id, param_name)
);
CREATE TABLE IF NOT EXISTS trial_values (
    trial_id INTEGER NOT NULL REFERENCES trials(trial_id) ON DELETE CASCADE,
    objective INTEGER NOT NULL,
    value {float},
    value_type INTEGER NOT NULL DEFAULT 0, -- 0 finite, 1 +inf, 2 -inf
    PRIMARY KEY (trial_id, objective)
);
CREATE TABLE IF NOT EXISTS trial_intermediate_values (
    trial_id INTEGER NOT NULL REFERENCES trials(trial_id) ON DELETE CASCADE,
    step INTEGER NOT NULL,
    intermediate_value {float},
    value_type INTEGER NOT NULL DEFAULT 0, -- 0 finite, 1 +inf, 2 -inf, 3 nan
    PRIMARY KEY (trial_id, step)
);
CREATE TABLE IF NOT EXISTS trial_user_attributes (
    trial_id INTEGER NOT NULL REFERENCES trials(trial_id) ON DELETE CASCADE,
    key {skey} NOT NULL,
    value_json TEXT,
    PRIMARY KEY (trial_id, key)
);
CREATE TABLE IF NOT EXISTS trial_system_attributes (
    trial_id INTEGER NOT NULL REFERENCES trials(trial_id) ON DELETE CASCADE,
    key {skey} NOT NULL,
    value_json TEXT,
    PRIMARY KEY (trial_id, key)
);
CREATE TABLE IF NOT EXISTS trial_heartbeats (
    trial_id INTEGER PRIMARY KEY REFERENCES trials(trial_id) ON DELETE CASCADE,
    heartbeat {float} NOT NULL
);
CREATE TABLE IF NOT EXISTS version_info (
    version_info_id INTEGER PRIMARY KEY CHECK (version_info_id = 1),
    schema_version INTEGER NOT NULL
);
"""


def _encode_value(v: float) -> tuple[float | None, int]:
    if v == float("inf"):
        return None, 1
    if v == float("-inf"):
        return None, 2
    if v != v:  # nan
        return None, 3
    return float(v), 0


def _decode_value(value: float | None, value_type: int) -> float:
    if value_type == 1:
        return float("inf")
    if value_type == 2:
        return float("-inf")
    if value_type == 3:
        return float("nan")
    assert value is not None
    return float(value)


def _dt_str(dt: datetime.datetime | None) -> str | None:
    return None if dt is None else dt.isoformat()


def _parse_dt(s: str | None) -> datetime.datetime | None:
    return None if s is None else datetime.datetime.fromisoformat(s)


class RDBStorage(BaseStorage, BaseHeartbeat):
    def __init__(
        self,
        url: str,
        *,
        heartbeat_interval: int | None = None,
        grace_period: int | None = None,
        failed_trial_callback: Callable | None = None,
        engine_kwargs: dict[str, Any] | None = None,
        skip_compatibility_check: bool = False,
        skip_table_creation: bool = False,
    ) -> None:
        if heartbeat_interval is not None and heartbeat_interval <= 0:
            raise ValueError("The value of `heartbeat_interval` should be a positive integer.")
        if grace_period is not None and grace_period <= 0:
            raise ValueError("The value of `grace_period` should be a positive integer.")
        self._url = url
        self._d = make_dialect(url, engine_kwargs)
        self.heartbeat_interval = heartbeat_interval
        self.grace_period = grace_period
        self.failed_trial_callback = failed_trial_callback
        self._local = threading.local()
        if not skip_table_creation:
            con = self._conn()
            self._d.create_schema(con, _SCHEMA)
            con.execute(
                "INSERT OR IGNORE INTO version_info (version_info_id, schema_version) VALUES (1, ?)",
                (SCHEMA_VERSION,),
            )
            row = con.execute("SELECT schema_version FROM version_info").fetchone()
            if not skip_compatibility_check and row is not None and row[0] != SCHEMA_VERSION:
                raise RuntimeError(
                    f"The runtime schema version {SCHEMA_VERSION} is incompatible with "
                    f"the storage's {row[0]}. Run the storage upgrade: "
                    "`RDBStorage(url, skip_compatibility_check=True).upgrade()`."
                )

    @staticmethod
    def _fill_storage_url_template(template: str) -> str:
        """Reference ``storage.py:1003``: substitute ``{SCHEMA_VERSION}`` in a
        storage URL template (used to keep per-schema-version databases)."""
        return template.format(SCHEMA_VERSION=SCHEMA_VERSION)

    # -------------------------------------------------------------- low level

    def _conn(self) -> sqlite3.Connection:
        con = getattr(self._local, "con", None)
        if con is not None:
            # Server dialects validate pooled connections before reuse
            # (pool_pre_ping); a stale one comes back None and is rebuilt.
            con = self._d.checkout(con)
        if con is None:
            con = self._d.connect()
            self._local.con = con
        return con

    def _txn(self) -> "RDBStorage._Txn":
        return RDBStorage._Txn(self)

    class _Txn:
        """Write transaction (scoped-session analogue). SQLite begins
        IMMEDIATE with a busy-retry loop; server dialects begin a plain
        transaction and rely on ``FOR UPDATE`` row locks at the read sites."""

        def __init__(self, storage: "RDBStorage") -> None:
            self._storage = storage
            self._con: sqlite3.Connection | None = None

        def __enter__(self) -> sqlite3.Connection:
            con = self._storage._conn()
            self._storage._d.begin(con)
            self._con = con
            return con

        def __exit__(self, exc_type, exc, tb) -> None:
            assert self._con is not None
            if exc_type is None:
                self._con.execute("COMMIT")
            else:
                self._con.execute("ROLLBACK")

    # ------------------------------------------------------ schema versioning

    def get_current_version(self) -> str:
        """The schema version of the backing database (reference
        ``storage.py:1026`` exposes alembic revisions; here versions are
        small integers rendered as ``v{N}``)."""
        row = self._conn().execute("SELECT schema_version FROM version_info").fetchone()
        return f"v{row[0]}" if row else "v0"

    def get_head_version(self) -> str:
        return f"v{SCHEMA_VERSION}"

    def get_all_versions(self) -> list[str]:
        return [f"v{n}" for n in range(1, SCHEMA_VERSION + 1)]

    def upgrade(self) -> None:
        """Walk the migration chain from the database's version to head.

        Each step applies inside one IMMEDIATE transaction, so a crash
        mid-step leaves the database at a well-defined version."""
        while True:
            row = self._conn().execute(
                "SELECT schema_version FROM version_info"
            ).fetchone()
            current = row[0] if row else 0
            if current >= SCHEMA_VERSION:
                return
            steps = _MIGRATIONS.get(current)
            if steps is None:
                raise RuntimeError(
                    f"No migration path from schema v{current} to v{SCHEMA_VERSION}."
                )
            _logger.info(f"Upgrading RDB schema v{current} -> v{current + 1}.")
            with self._txn() as con:
                for sql in steps:
                    # Dialect-routed: MySQL strips CREATE INDEX IF NOT EXISTS
                    # and tolerates already-exists (its DDL implicit-commits,
                    # so a crashed upgrade may have applied a prefix).
                    self._d.execute_ddl(con, sql)
                con.execute(
                    "UPDATE version_info SET schema_version = ?", (current + 1,)
                )

    def remove_session(self) -> None:
        con = getattr(self._local, "con", None)
        if con is not None:
            con.close()
            self._local.con = None

    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        del state["_local"]
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._local = threading.local()

    # ------------------------------------------------------------------ study

    def create_new_study(
        self, directions: Sequence[StudyDirection], study_name: str | None = None
    ) -> int:
        import uuid

        study_name = study_name or DEFAULT_STUDY_NAME_PREFIX + str(uuid.uuid4())
        try:
            with self._txn() as con:
                study_id = self._d.insert_id(
                    con,
                    "INSERT INTO studies (study_name, created_at) VALUES (?, ?)",
                    (study_name, datetime.datetime.now().isoformat()),
                    "study_id",
                )
                con.executemany(
                    "INSERT INTO study_directions (study_id, objective, direction) VALUES (?, ?, ?)",
                    [(study_id, i, int(d)) for i, d in enumerate(directions)],
                )
        except self._d.integrity_errors as e:
            raise DuplicatedStudyError(
                f"Another study with name '{study_name}' already exists."
            ) from e
        _logger.info(f"A new study created in RDB with name: {study_name}")
        return int(study_id)

    def delete_study(self, study_id: int) -> None:
        with self._txn() as con:
            self._check_study_exists(con, study_id, lock=True)
            # Explicit child-row deletes: MySQL parses but DISCARDS the
            # schema's inline column-level REFERENCES ... ON DELETE CASCADE
            # clauses, so relying on cascades would orphan every child row
            # there. Deleting bottom-up is portable across all dialects
            # (sqlite/PG cascades then find nothing left to do).
            trial_sub = "(SELECT trial_id FROM trials WHERE study_id = ?)"
            for table in (
                "trial_params",
                "trial_values",
                "trial_intermediate_values",
                "trial_user_attributes",
                "trial_system_attributes",
                "trial_heartbeats",
            ):
                con.execute(
                    f"DELETE FROM {table} WHERE trial_id IN {trial_sub}", (study_id,)
                )
            for table in (
                "trials",
                "study_directions",
                "study_user_attributes",
                "study_system_attributes",
            ):
                con.execute(f"DELETE FROM {table} WHERE study_id = ?", (study_id,))
            con.execute("DELETE FROM studies WHERE study_id = ?", (study_id,))

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        self._set_attr("study_user_attributes", "study_id", study_id, key, value)

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        self._set_attr("study_system_attributes", "study_id", study_id, key, value)

    def _set_attr(self, table: str, id_col: str, id_val: int, key: str, value: Any) -> None:
        with self._txn() as con:
            if id_col == "study_id":
                self._check_study_exists(con, id_val, lock=True)
            else:
                self._check_trial_updatable(con, id_val)
            con.execute(
                f"INSERT INTO {table} ({id_col}, key, value_json) VALUES (?, ?, ?) "
                f"ON CONFLICT({id_col}, key) DO UPDATE SET value_json = excluded.value_json",
                (id_val, key, json.dumps(value)),
            )

    def get_study_id_from_name(self, study_name: str) -> int:
        row = self._conn().execute(
            "SELECT study_id FROM studies WHERE study_name = ?", (study_name,)
        ).fetchone()
        if row is None:
            raise KeyError(f"No such study {study_name}.")
        return int(row[0])

    def get_study_name_from_id(self, study_id: int) -> str:
        row = self._conn().execute(
            "SELECT study_name FROM studies WHERE study_id = ?", (study_id,)
        ).fetchone()
        if row is None:
            raise KeyError(f"No study with study_id {study_id} exists.")
        return str(row[0])

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        rows = self._conn().execute(
            "SELECT direction FROM study_directions WHERE study_id = ? ORDER BY objective",
            (study_id,),
        ).fetchall()
        if not rows:
            raise KeyError(f"No study with study_id {study_id} exists.")
        return [StudyDirection(r[0]) for r in rows]

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        return self._get_attrs("study_user_attributes", "study_id", study_id)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        return self._get_attrs("study_system_attributes", "study_id", study_id)

    def _get_attrs(self, table: str, id_col: str, id_val: int) -> dict[str, Any]:
        rows = self._conn().execute(
            f"SELECT key, value_json FROM {table} WHERE {id_col} = ?", (id_val,)
        ).fetchall()
        return {k: json.loads(v) for k, v in rows}

    def get_all_studies(self) -> list[FrozenStudy]:
        con = self._conn()
        studies = con.execute("SELECT study_id, study_name FROM studies ORDER BY study_id").fetchall()
        out = []
        for study_id, name in studies:
            directions = self.get_study_directions(study_id)
            out.append(
                FrozenStudy(
                    study_name=name,
                    direction=None,
                    directions=directions,
                    user_attrs=self.get_study_user_attrs(study_id),
                    system_attrs=self.get_study_system_attrs(study_id),
                    study_id=study_id,
                )
            )
        return out

    def _check_study_exists(
        self, con: sqlite3.Connection, study_id: int, lock: bool = False
    ) -> None:
        # lock=True (inside write txns) takes a FOR UPDATE row lock on server
        # dialects, serializing per-study writers — in particular the
        # MAX(number)+1 trial-number assignment, where an aggregate SELECT
        # cannot itself carry FOR UPDATE. SQLite's suffix is empty: BEGIN
        # IMMEDIATE already serializes writers globally.
        suffix = self._d.for_update if lock else ""
        row = con.execute(
            "SELECT 1 FROM studies WHERE study_id = ?" + suffix, (study_id,)
        ).fetchone()
        if row is None:
            raise KeyError(f"No study with study_id {study_id} exists.")

    # ------------------------------------------------------------------ trial

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        with self._txn() as con:
            self._check_study_exists(con, study_id, lock=True)
            row = con.execute(
                "SELECT COALESCE(MAX(number), -1) + 1 FROM trials WHERE study_id = ?",
                (study_id,),
            ).fetchone()
            number = int(row[0])
            return self._insert_trial_row(con, study_id, number, template_trial)

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        """Batch create in ONE transaction (one commit for the whole batch)."""
        with self._txn() as con:
            self._check_study_exists(con, study_id, lock=True)
            row = con.execute(
                "SELECT COALESCE(MAX(number), -1) + 1 FROM trials WHERE study_id = ?",
                (study_id,),
            ).fetchone()
            start = int(row[0])
            return [
                self._insert_trial_row(con, study_id, start + i, template_trial)
                for i in range(n)
            ]

    def _insert_trial_row(
        self,
        con: sqlite3.Connection,
        study_id: int,
        number: int,
        template_trial: FrozenTrial | None,
    ) -> int:
        if template_trial is None:
            trial_id = self._d.insert_id(
                con,
                "INSERT INTO trials (number, study_id, state, datetime_start) VALUES (?, ?, ?, ?)",
                (
                    number,
                    study_id,
                    int(TrialState.RUNNING),
                    _dt_str(datetime.datetime.now()),
                ),
                "trial_id",
            )
            self._record_initial_heartbeat(con, trial_id)
            return trial_id
        t = template_trial
        trial_id = self._d.insert_id(
            con,
            "INSERT INTO trials (number, study_id, state, datetime_start, datetime_complete) "
            "VALUES (?, ?, ?, ?, ?)",
            (
                number,
                study_id,
                int(t.state),
                _dt_str(t.datetime_start),
                _dt_str(t.datetime_complete),
            ),
            "trial_id",
        )
        for name, value in t.params.items():
            dist = t.distributions[name]
            con.execute(
                "INSERT INTO trial_params (trial_id, param_name, param_value, distribution_json) "
                "VALUES (?, ?, ?, ?)",
                (trial_id, name, dist.to_internal_repr(value), distribution_to_json(dist)),
            )
        if t.values is not None:
            for i, v in enumerate(t.values):
                value, value_type = _encode_value(v)
                con.execute(
                    "INSERT INTO trial_values (trial_id, objective, value, value_type) "
                    "VALUES (?, ?, ?, ?)",
                    (trial_id, i, value, value_type),
                )
        for step, v in t.intermediate_values.items():
            value, value_type = _encode_value(v)
            con.execute(
                "INSERT INTO trial_intermediate_values (trial_id, step, intermediate_value, value_type) "
                "VALUES (?, ?, ?, ?)",
                (trial_id, step, value, value_type),
            )
        for key, v in t.user_attrs.items():
            con.execute(
                "INSERT INTO trial_user_attributes (trial_id, key, value_json) VALUES (?, ?, ?)",
                (trial_id, key, json.dumps(v)),
            )
        for key, v in t.system_attrs.items():
            con.execute(
                "INSERT INTO trial_system_attributes (trial_id, key, value_json) VALUES (?, ?, ?)",
                (trial_id, key, json.dumps(v)),
            )
        if t.state == TrialState.RUNNING:
            self._record_initial_heartbeat(con, trial_id)
        return trial_id

    def _record_initial_heartbeat(self, con: sqlite3.Connection, trial_id: int) -> None:
        """The RUNNING commit doubles as the trial's first beat, in the same
        transaction — so there is no commit-to-first-beat window at all: a
        worker SIGKILL'd at any point after its trials became RUNNING leaves
        them reapable (``_get_stale_trial_ids`` joins on heartbeat rows, and
        epoch-based rows are immune to cross-host timezone/clock-basis skew,
        unlike the ISO-text ``datetime_start`` column). Deliberate
        consequence: on a heartbeat storage, a RUNNING trial that never
        beats again (a bare ``ask()`` outside optimize, which already warns)
        goes stale after the grace period."""
        if self.heartbeat_interval is None:
            return
        con.execute(
            "INSERT INTO trial_heartbeats (trial_id, heartbeat) VALUES (?, ?) "
            "ON CONFLICT(trial_id) DO UPDATE SET heartbeat = excluded.heartbeat",
            (trial_id, time.time()),
        )

    def _check_trial_updatable(self, con: sqlite3.Connection, trial_id: int) -> None:
        # Always called inside a write txn: the FOR UPDATE suffix (server
        # dialects) locks the trial row so the state check and the following
        # write are atomic under concurrent workers.
        row = con.execute(
            "SELECT state, number FROM trials WHERE trial_id = ?" + self._d.for_update,
            (trial_id,),
        ).fetchone()
        if row is None:
            raise KeyError(f"No trial with trial_id {trial_id} exists.")
        if TrialState(row[0]).is_finished():
            raise UpdateFinishedTrialError(
                f"Trial#{row[1]} has already finished and can not be updated."
            )

    def set_trial_param(
        self,
        trial_id: int,
        param_name: str,
        param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        with self._txn() as con:
            self._check_trial_updatable(con, trial_id)
            prev = con.execute(
                "SELECT distribution_json FROM trial_params WHERE trial_id = ? AND param_name = ?",
                (trial_id, param_name),
            ).fetchone()
            if prev is not None:
                check_distribution_compatibility(
                    json_to_distribution(prev[0]), distribution
                )
            con.execute(
                "INSERT INTO trial_params (trial_id, param_name, param_value, distribution_json) "
                "VALUES (?, ?, ?, ?) "
                "ON CONFLICT(trial_id, param_name) DO UPDATE SET "
                "param_value = excluded.param_value, distribution_json = excluded.distribution_json",
                (trial_id, param_name, param_value_internal, distribution_to_json(distribution)),
            )

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Sequence[float] | None = None
    ) -> bool:
        now = _dt_str(datetime.datetime.now())
        with self._txn() as con:
            # FOR UPDATE on server dialects: the WAITING->RUNNING claim CAS
            # must read-then-write atomically or two workers both claim.
            row = con.execute(
                "SELECT state, number FROM trials WHERE trial_id = ?" + self._d.for_update,
                (trial_id,),
            ).fetchone()
            if row is None:
                raise KeyError(f"No trial with trial_id {trial_id} exists.")
            current = TrialState(row[0])
            if current.is_finished():
                raise UpdateFinishedTrialError(
                    f"Trial#{row[1]} has already finished and can not be updated."
                )
            if state == TrialState.RUNNING and current != TrialState.WAITING:
                return False
            sets = ["state = ?"]
            args: list[Any] = [int(state)]
            if state == TrialState.RUNNING:
                sets.append("datetime_start = ?")
                args.append(now)
            if state.is_finished():
                sets.append("datetime_complete = ?")
                args.append(now)
            args.append(trial_id)
            con.execute(f"UPDATE trials SET {', '.join(sets)} WHERE trial_id = ?", args)
            if state == TrialState.RUNNING:
                # A WAITING->RUNNING claim beats atomically with the claim,
                # same rationale as _record_initial_heartbeat at creation.
                self._record_initial_heartbeat(con, trial_id)
            if values is not None:
                con.execute("DELETE FROM trial_values WHERE trial_id = ?", (trial_id,))
                for i, v in enumerate(values):
                    value, value_type = _encode_value(float(v))
                    con.execute(
                        "INSERT INTO trial_values (trial_id, objective, value, value_type) "
                        "VALUES (?, ?, ?, ?)",
                        (trial_id, i, value, value_type),
                    )
            return True

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        with self._txn() as con:
            self._check_trial_updatable(con, trial_id)
            value, value_type = _encode_value(float(intermediate_value))
            con.execute(
                "INSERT INTO trial_intermediate_values (trial_id, step, intermediate_value, value_type) "
                "VALUES (?, ?, ?, ?) "
                "ON CONFLICT(trial_id, step) DO UPDATE SET "
                "intermediate_value = excluded.intermediate_value, value_type = excluded.value_type",
                (trial_id, step, value, value_type),
            )

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._set_attr("trial_user_attributes", "trial_id", trial_id, key, value)

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._set_attr("trial_system_attributes", "trial_id", trial_id, key, value)

    def get_trial(self, trial_id: int) -> FrozenTrial:
        con = self._conn()
        row = con.execute(
            "SELECT trial_id, number, study_id, state, datetime_start, datetime_complete "
            "FROM trials WHERE trial_id = ?",
            (trial_id,),
        ).fetchone()
        if row is None:
            raise KeyError(f"No trial with trial_id {trial_id} exists.")
        return self._build_trials(con, [row])[0]

    def get_all_trials(
        self,
        study_id: int,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
    ) -> list[FrozenTrial]:
        con = self._conn()
        if con.execute("SELECT 1 FROM studies WHERE study_id = ?", (study_id,)).fetchone() is None:
            raise KeyError(f"No study with study_id {study_id} exists.")
        rows = con.execute(
            "SELECT trial_id, number, study_id, state, datetime_start, datetime_complete "
            "FROM trials WHERE study_id = ? ORDER BY trial_id",
            (study_id,),
        ).fetchall()
        trials = self._build_trials(con, rows)
        if states is not None:
            trials = [t for t in trials if t.state in states]
        return trials

    def _read_trials_partial(
        self, study_id: int, max_known_trial_id: int, extra_ids: set[int]
    ) -> list[FrozenTrial]:
        """Trials newer than ``max_known_trial_id`` plus the explicitly listed
        (unfinished) ids — the incremental read used by ``_CachedStorage``."""
        con = self._conn()
        if con.execute("SELECT 1 FROM studies WHERE study_id = ?", (study_id,)).fetchone() is None:
            raise KeyError(f"No study with study_id {study_id} exists.")
        extra = sorted(extra_ids)
        qmarks = ",".join("?" * len(extra))
        clause = f"OR trial_id IN ({qmarks})" if extra else ""
        rows = con.execute(
            "SELECT trial_id, number, study_id, state, datetime_start, datetime_complete "
            f"FROM trials WHERE study_id = ? AND (trial_id > ? {clause}) ORDER BY trial_id",
            [study_id, max_known_trial_id, *extra],
        ).fetchall()
        return self._build_trials(con, rows)

    _MAX_SQL_VARS = 500  # stay under sqlite's host-parameter limit

    def _build_trials(self, con: sqlite3.Connection, rows: list) -> list[FrozenTrial]:
        if not rows:
            return []
        if len(rows) > self._MAX_SQL_VARS:
            out: list[FrozenTrial] = []
            for s in range(0, len(rows), self._MAX_SQL_VARS):
                out.extend(self._build_trials(con, rows[s : s + self._MAX_SQL_VARS]))
            return out
        ids = [r[0] for r in rows]
        qmarks = ",".join("?" * len(ids))
        params: dict[int, dict[str, Any]] = {i: {} for i in ids}
        dists: dict[int, dict[str, BaseDistribution]] = {i: {} for i in ids}
        for tid, name, value, dist_json in con.execute(
            f"SELECT trial_id, param_name, param_value, distribution_json FROM trial_params "
            f"WHERE trial_id IN ({qmarks})",
            ids,
        ):
            dist = json_to_distribution(dist_json)
            dists[tid][name] = dist
            params[tid][name] = dist.to_external_repr(value)
        values: dict[int, dict[int, float]] = {i: {} for i in ids}
        for tid, objective, value, value_type in con.execute(
            f"SELECT trial_id, objective, value, value_type FROM trial_values "
            f"WHERE trial_id IN ({qmarks})",
            ids,
        ):
            values[tid][objective] = _decode_value(value, value_type)
        inter: dict[int, dict[int, float]] = {i: {} for i in ids}
        for tid, step, value, value_type in con.execute(
            f"SELECT trial_id, step, intermediate_value, value_type FROM trial_intermediate_values "
            f"WHERE trial_id IN ({qmarks})",
            ids,
        ):
            inter[tid][step] = _decode_value(value, value_type)
        uattrs: dict[int, dict[str, Any]] = {i: {} for i in ids}
        for tid, key, vjson in con.execute(
            f"SELECT trial_id, key, value_json FROM trial_user_attributes WHERE trial_id IN ({qmarks})",
            ids,
        ):
            uattrs[tid][key] = json.loads(vjson)
        sattrs: dict[int, dict[str, Any]] = {i: {} for i in ids}
        for tid, key, vjson in con.execute(
            f"SELECT trial_id, key, value_json FROM trial_system_attributes WHERE trial_id IN ({qmarks})",
            ids,
        ):
            sattrs[tid][key] = json.loads(vjson)

        out = []
        for tid, number, _study_id, state, dt_start, dt_complete in rows:
            vals = values[tid]
            ordered = [vals[k] for k in sorted(vals)] if vals else None
            out.append(
                FrozenTrial(
                    number=number,
                    trial_id=tid,
                    state=TrialState(state),
                    value=None,
                    values=ordered,
                    datetime_start=_parse_dt(dt_start),
                    datetime_complete=_parse_dt(dt_complete),
                    params=params[tid],
                    distributions=dists[tid],
                    user_attrs=uattrs[tid],
                    system_attrs=sattrs[tid],
                    intermediate_values=inter[tid],
                )
            )
        return out

    # -------------------------------------------------------------- heartbeat

    def record_heartbeat(self, trial_id: int) -> None:
        with self._txn() as con:
            con.execute(
                "INSERT INTO trial_heartbeats (trial_id, heartbeat) VALUES (?, ?) "
                "ON CONFLICT(trial_id) DO UPDATE SET heartbeat = excluded.heartbeat",
                (trial_id, time.time()),
            )

    def _get_stale_trial_ids(self, study_id: int) -> list[int]:
        assert self.heartbeat_interval is not None
        grace = self.grace_period or self.heartbeat_interval * 2
        cutoff = time.time() - grace
        # The inner join is safe: every RUNNING commit writes its first beat
        # in the same transaction (_record_initial_heartbeat), so beat-less
        # RUNNING trials cannot exist on a heartbeat-enabled storage and the
        # comparison stays purely epoch-based (immune to cross-host timezone
        # or clock-basis skew, which the ISO-text datetime_start column is
        # not).
        rows = self._conn().execute(
            "SELECT t.trial_id FROM trials t JOIN trial_heartbeats h ON t.trial_id = h.trial_id "
            "WHERE t.study_id = ? AND t.state = ? AND h.heartbeat < ?",
            (study_id, int(TrialState.RUNNING), cutoff),
        ).fetchall()
        return [int(r[0]) for r in rows]

    def get_heartbeat_interval(self) -> int | None:
        return self.heartbeat_interval

    def get_failed_trial_callback(self) -> Callable | None:
        return self.failed_trial_callback
