"""Server-dialect layer: one canonical SQL flavor, three wire dialects (port
of ``optuna_tpu/storages/_rdb/_dialect.py``).

The storage core (``storage.py``) writes a single canonical SQL dialect —
SQLite's (qmark parameters, ``ON CONFLICT ... DO UPDATE SET x = excluded.x``
upserts) — and this module adapts statements to MySQL and PostgreSQL at the
connection boundary. The reference gets this adaptation from SQLAlchemy
(``optuna/storages/_rdb/storage.py:106`` rides the ORM; its only explicit
server handling is MySQL ``pool_pre_ping`` at ``storage.py:986-1000`` and
URL templating at ``storage.py:1003``); here the translation is explicit
and ~200 lines instead of a SQLAlchemy dependency.

What differs per dialect and is handled here:

* parameter style: ``?`` (sqlite qmark) vs ``%s`` (DBAPI format),
* upserts: ``ON DUPLICATE KEY UPDATE x = VALUES(x)`` on MySQL,
* ``INSERT OR IGNORE`` vs ``INSERT IGNORE`` vs ``ON CONFLICT DO NOTHING``,
* autoincrement PK / float column DDL types, MySQL VARCHAR key lengths,
* the reserved word ``key`` (MySQL needs backticks),
* last-insert-id retrieval (PostgreSQL wants ``RETURNING``),
* row locking: SQLite serializes writers via ``BEGIN IMMEDIATE``; server
  dialects take ``SELECT ... FOR UPDATE`` row locks inside transactions so
  the WAITING->RUNNING claim CAS and trial-number assignment stay atomic
  under concurrent workers (the consistency contract of
  ``optuna/storages/_base.py:21-51``),
* connection liveness: MySQL connections are pinged on checkout
  (``pool_pre_ping`` parity with reference ``storage.py:997-1000``).

Drivers are resolved lazily: ``mysql://`` tries MySQLdb then pymysql,
``postgresql://`` tries psycopg2 then psycopg; an explicit
``mysql+pymysql://`` names the module. Nothing is imported until a server
URL is actually used, and a missing driver raises with both the pip hint
and the serverless migration paths (journal file, Redis journal).
"""

from __future__ import annotations

import re
import sqlite3
from typing import Any, Sequence
from urllib.parse import parse_qsl, unquote, urlsplit

_MIGRATION_GUIDANCE = (
    "Alternatively, multi-host studies run without any database server: use "
    "JournalStorage(JournalFileBackend(path)) on a shared filesystem, or "
    "JournalStorage(JournalRedisBackend(url))."
)

# Known DBAPI drivers per server family, in preference order. An explicit
# ``+driver`` URL suffix outside this table is imported verbatim, which is
# also the seam the fake-DBAPI test shim uses. Values are (module name,
# pip package name) — they differ (MySQLdb ships as mysqlclient).
_MYSQL_DRIVERS = {"mysqldb": ("MySQLdb", "mysqlclient"), "pymysql": ("pymysql", "pymysql")}
_PG_DRIVERS = {"psycopg2": ("psycopg2", "psycopg2-binary"), "psycopg": ("psycopg", "psycopg")}


def _import_driver(family: str, explicit: str, table: dict[str, tuple[str, str]]) -> Any:
    import importlib

    candidates = (
        [table.get(explicit, (explicit, explicit))] if explicit else list(table.values())
    )
    errors = []
    for mod_name, _pip in candidates:
        try:
            return importlib.import_module(mod_name)
        except ImportError as err:
            errors.append(f"{mod_name}: {err}")
    pip_hint = " or ".join(f"`pip install {pip}`" for _mod, pip in candidates)
    raise ImportError(
        f"A {family} URL needs a DBAPI driver but none could be imported "
        f"({'; '.join(errors)}). Install one ({pip_hint}). "
        + _MIGRATION_GUIDANCE
    )


class _ParsedUrl:
    def __init__(self, url: str) -> None:
        parts = urlsplit(url)
        scheme = parts.scheme
        self.family, _, self.driver = scheme.partition("+")
        self.host = parts.hostname or "localhost"
        self.port = parts.port
        self.user = unquote(parts.username) if parts.username else None
        self.password = unquote(parts.password) if parts.password else None
        self.database = parts.path.lstrip("/")
        self.query = dict(parse_qsl(parts.query))


_ADD_COLUMN_RE = re.compile(r"\s*ALTER\s+TABLE\s+\S+\s+ADD\s+(COLUMN\s+)?\S+", re.IGNORECASE)


class SqliteDialect:
    """Identity dialect: canonical SQL runs as written."""

    name = "sqlite"
    for_update = ""  # BEGIN IMMEDIATE already serializes writers

    def __init__(self, path: str) -> None:
        self._path = path

    def connect(self) -> sqlite3.Connection:
        con = sqlite3.connect(self._path, timeout=60.0, isolation_level=None)
        con.execute("PRAGMA journal_mode=WAL")
        con.execute("PRAGMA synchronous=NORMAL")
        con.execute("PRAGMA foreign_keys=ON")
        return con

    def checkout(self, con: sqlite3.Connection) -> sqlite3.Connection | None:
        return con  # local file handles don't go stale

    @property
    def integrity_errors(self) -> tuple[type[Exception], ...]:
        return (sqlite3.IntegrityError,)

    def translate(self, sql: str) -> str:
        return sql

    def ddl_types(self) -> dict[str, str]:
        return {
            "autopk": "INTEGER PRIMARY KEY AUTOINCREMENT",
            "skey": "TEXT",
            "float": "REAL",
        }

    def create_schema(self, con: Any, schema_template: str) -> None:
        # executescript issues its own COMMIT; DDL here is idempotent.
        con.executescript(schema_template.format(**self.ddl_types()))

    def execute_ddl(self, con: Any, stmt: str) -> None:
        # CREATE statements use IF NOT EXISTS natively, but sqlite has no
        # ALTER TABLE ... ADD COLUMN IF NOT EXISTS — tolerate an
        # already-applied ADD COLUMN so a migration interrupted after a DDL
        # prefix (or a database touched by a newer process) completes
        # idempotently on retry. ONLY that shape is swallowed: an
        # 'already exists' from any other statement means a genuinely
        # conflicting stale schema (e.g. a CREATE without IF NOT EXISTS
        # colliding with a leftover table) and must surface, not no-op.
        try:
            con.execute(stmt)
        except sqlite3.OperationalError as err:
            msg = str(err).lower()
            is_add_column = _ADD_COLUMN_RE.match(stmt) is not None
            if not (
                is_add_column
                and ("duplicate column name" in msg or "already exists" in msg)
            ):
                raise

    def insert_id(self, con: Any, sql: str, args: Sequence[Any], id_col: str) -> int:
        return int(con.execute(sql, args).lastrowid)

    def begin(self, con: Any) -> None:
        # IMMEDIATE + busy retry: the scoped-session analogue. Only
        # contention is retryable; "no such table" etc. surface immediately.
        import time

        last: sqlite3.OperationalError | None = None
        for attempt in range(60):
            try:
                con.execute("BEGIN IMMEDIATE")
                return
            except sqlite3.OperationalError as err:
                msg = str(err).lower()
                if "locked" not in msg and "busy" not in msg:
                    raise
                last = err
                time.sleep(0.05 * (attempt + 1))
        raise sqlite3.OperationalError("database is locked") from last


_UPSERT_RE = re.compile(
    r"ON\s+CONFLICT\s*\(([^)]*)\)\s*DO\s+UPDATE\s+SET\s+(.*)$",
    re.DOTALL | re.IGNORECASE,
)
_EXCLUDED_RE = re.compile(r"excluded\.(\w+)", re.IGNORECASE)
_KEY_COL_RE = re.compile(r"\bkey\b")  # case-sensitive: skips "PRIMARY KEY"
# Translation-completeness check: any sqlite-only construct surviving into a
# server dialect means a rewrite regex silently failed to match.
_SQLITE_ONLY_RE = re.compile(r"ON\s+CONFLICT\s*\(|excluded\.|INSERT\s+OR\s+IGNORE", re.IGNORECASE)


class _ServerDialect:
    """Shared translation machinery for MySQL/PostgreSQL."""

    name = "server"
    for_update = " FOR UPDATE"

    def __init__(self, url: str, engine_kwargs: dict[str, Any] | None) -> None:
        self._url = _ParsedUrl(url)
        self._engine_kwargs = dict(engine_kwargs or {})
        self._module = self._resolve_driver()
        self._translate_cache: dict[str, str] = {}  # statement set is small and fixed

    def _resolve_driver(self) -> Any:  # pragma: no cover - per subclass
        raise NotImplementedError

    # Storages travel to worker processes by pickle; module objects don't.
    # Drop the driver handle and re-resolve it on the far side.
    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        del state["_module"]
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._module = self._resolve_driver()

    @property
    def integrity_errors(self) -> tuple[type[Exception], ...]:
        return (sqlite3.IntegrityError, self._module.IntegrityError)

    # Overridden per dialect: constructs that must NOT survive translation
    # (PostgreSQL speaks ON CONFLICT natively, so it only bans the sqlite
    # INSERT OR IGNORE spelling; MySQL bans all three).
    _forbidden_after_translate = re.compile(r"INSERT\s+OR\s+IGNORE", re.IGNORECASE)

    def translate(self, sql: str) -> str:
        cached = self._translate_cache.get(sql)
        if cached is not None:
            return cached
        out = self._rewrite_upsert(sql)
        out = self._rewrite_insert_ignore(out)
        out = self._quote_key_column(out)
        out = out.replace("?", "%s")
        if self._forbidden_after_translate.search(out) is not None:
            raise RuntimeError(
                f"SQL rewrite incomplete for {self.name}: sqlite-only syntax "
                f"survived translation: {out[:200]!r}"
            )
        self._translate_cache[sql] = out
        return out

    # Per-dialect rewrite hooks ------------------------------------------

    def _rewrite_upsert(self, sql: str) -> str:
        return sql

    def _rewrite_insert_ignore(self, sql: str) -> str:
        return sql

    def _quote_key_column(self, sql: str) -> str:
        return sql

    def _is_exists_error(self, err: Exception) -> bool:
        return "already exists" in str(err).lower()

    # Shared plumbing ----------------------------------------------------

    def execute_ddl(self, con: Any, stmt: str) -> None:
        """One DDL statement, tolerating already-exists errors (MySQL lacks
        CREATE INDEX IF NOT EXISTS). Used by schema creation AND the
        migration chain, so upgrades speak the dialect too."""
        try:
            con.execute(self._rewrite_ddl(stmt))
        except Exception as err:  # graphlint: ignore[PY001] -- DBAPI drivers each raise their own OperationalError family; _is_exists_error classifies, the rest re-raise
            if not self._is_exists_error(err):
                raise

    def _rewrite_ddl(self, stmt: str) -> str:
        return stmt

    def create_schema(self, con: Any, schema_template: str) -> None:
        # No executescript on server DBAPIs; run per-statement.
        for stmt in schema_template.format(**self.ddl_types()).split(";"):
            stmt = stmt.strip()
            if stmt:
                self.execute_ddl(con, stmt)

    def insert_id(self, con: Any, sql: str, args: Sequence[Any], id_col: str) -> int:
        return int(con.execute(sql, args).lastrowid)

    def begin(self, con: Any) -> None:
        con.execute("BEGIN")

    def checkout(self, con: "_ServerConnection") -> "_ServerConnection | None":
        """Validate a pooled connection before reuse (pool_pre_ping parity,
        reference ``storage.py:997-1000``). Returns None if it went stale so
        the caller reconnects. Throttled: a connection used within the last
        few seconds cannot have hit ``wait_timeout``, so skip the ping."""
        if con.broken:
            # A prior execute hit a connection-level error (server restart,
            # killed session): hand back None so the caller reconnects
            # instead of surfacing repeated hard failures.
            try:
                con.close()
            except Exception:  # graphlint: ignore[PY001] -- closing a poisoned driver handle may raise anything; the pool just needs it gone
                pass
            return None
        if not self._engine_kwargs.get("pool_pre_ping", True):
            return con
        import time

        if time.monotonic() - con.last_used < 5.0:
            return con
        try:
            con.ping()
            return con
        except Exception:  # graphlint: ignore[PY001] -- pre-ping probe: any driver-flavored failure means the connection is dead, reconnect
            try:
                con.close()
            except Exception:  # graphlint: ignore[PY001] -- best-effort close of a connection the ping just proved dead
                pass
            return None

    def _connect_kwargs(self) -> dict[str, Any]:
        kw: dict[str, Any] = dict(self._engine_kwargs.get("connect_args", {}))
        u = self._url
        if u.host:
            kw.setdefault("host", u.host)
        if u.port:
            kw.setdefault("port", u.port)
        if u.user:
            kw.setdefault("user", u.user)
        if u.password:
            kw.setdefault("password", u.password)
        # URL query options reach the driver verbatim (sslmode=require,
        # charset=utf8mb4, connect_timeout=10, ...); digit strings become
        # ints since drivers type-check numeric options.
        for key, value in u.query.items():
            kw.setdefault(key, int(value) if value.isdigit() else value)
        return kw


class MySQLDialect(_ServerDialect):
    name = "mysql"
    _forbidden_after_translate = _SQLITE_ONLY_RE

    def _resolve_driver(self) -> Any:
        return _import_driver("MySQL", self._url.driver, _MYSQL_DRIVERS)

    def ddl_types(self) -> dict[str, str]:
        # VARCHAR(512) keeps composite keys under InnoDB's 3072-byte index
        # limit at utf8mb4 (512 * 4 = 2048 bytes).
        return {
            "autopk": "INTEGER PRIMARY KEY AUTO_INCREMENT",
            "skey": "VARCHAR(512)",
            "float": "DOUBLE",
        }

    _CREATE_INDEX_INE_RE = re.compile(r"(CREATE INDEX )IF NOT EXISTS ")

    def _rewrite_ddl(self, stmt: str) -> str:
        # MySQL has no CREATE INDEX IF NOT EXISTS: strip the clause and let
        # the duplicate-index error (1061) be tolerated instead.
        return self._CREATE_INDEX_INE_RE.sub(r"\1", stmt)

    def _is_exists_error(self, err: Exception) -> bool:
        # MySQL drivers put the server errno in args[0]: 1050 table exists,
        # 1061 duplicate key name (index exists), 1060 duplicate column.
        args = getattr(err, "args", ())
        if args and isinstance(args[0], int) and args[0] in (1050, 1060, 1061):
            return True
        return super()._is_exists_error(err)

    def _rewrite_upsert(self, sql: str) -> str:
        m = _UPSERT_RE.search(sql)
        if m is None:
            return sql
        assignments = _EXCLUDED_RE.sub(r"VALUES(\1)", m.group(2))
        return sql[: m.start()] + "ON DUPLICATE KEY UPDATE " + assignments

    def _rewrite_insert_ignore(self, sql: str) -> str:
        return sql.replace("INSERT OR IGNORE", "INSERT IGNORE")

    def _quote_key_column(self, sql: str) -> str:
        return _KEY_COL_RE.sub("`key`", sql)

    def connect(self) -> "_ServerConnection":
        kw = self._connect_kwargs()
        kw.setdefault("database", self._url.database)
        raw = self._module.connect(**kw)
        try:
            raw.autocommit(True)  # MySQLdb/pymysql API
        except TypeError:
            raw.autocommit = True
        return _ServerConnection(raw, self)


class PostgresDialect(_ServerDialect):
    name = "postgresql"

    def _resolve_driver(self) -> Any:
        return _import_driver("PostgreSQL", self._url.driver, _PG_DRIVERS)

    def ddl_types(self) -> dict[str, str]:
        return {
            "autopk": "SERIAL PRIMARY KEY",
            "skey": "TEXT",
            "float": "DOUBLE PRECISION",
        }

    def _rewrite_insert_ignore(self, sql: str) -> str:
        if "INSERT OR IGNORE" not in sql:
            return sql
        return sql.replace("INSERT OR IGNORE", "INSERT") + " ON CONFLICT DO NOTHING"

    def insert_id(self, con: Any, sql: str, args: Sequence[Any], id_col: str) -> int:
        row = con.execute(f"{sql} RETURNING {id_col}", args).fetchone()
        return int(row[0])

    def connect(self) -> "_ServerConnection":
        kw = self._connect_kwargs()
        kw.setdefault("dbname", self._url.database)
        raw = self._module.connect(**kw)
        raw.autocommit = True
        return _ServerConnection(raw, self)


class _ServerConnection:
    """Adapter giving server DBAPI connections the sqlite3.Connection
    surface the storage core talks to (``.execute`` returning a cursor)."""

    def __init__(self, raw: Any, dialect: _ServerDialect) -> None:
        self._raw = raw
        self._dialect = dialect
        self.last_used = 0.0
        self.broken = False

    def _touch(self) -> None:
        import time

        self.last_used = time.monotonic()

    def _is_connection_error(self, err: Exception) -> bool:
        """Did ``err`` kill the connection (vs. a retryable statement error)?

        OperationalError also covers deadlocks / lock-wait timeouts, which
        must NOT poison the handle — so consult the driver's own liveness
        flag first (psycopg ``closed``, pymysql ``open``), falling back to
        the MySQL connection-lost errnos."""
        mod = self._dialect._module
        iface = getattr(mod, "InterfaceError", None)
        if iface is not None and isinstance(err, iface):
            return True
        oper = getattr(mod, "OperationalError", None)
        if oper is None or not isinstance(err, oper):
            return False
        closed = getattr(self._raw, "closed", None)  # psycopg: truthy when dead
        if closed is not None:
            return bool(closed)
        is_open = getattr(self._raw, "open", None)  # pymysql: falsy when dead
        if is_open is not None:
            return not is_open
        args = getattr(err, "args", ())
        # 2006 server gone, 2013 lost connection, 2055 lost connection to
        # server, 4031 inactivity timeout.
        return bool(args and isinstance(args[0], int) and args[0] in (2006, 2013, 2055, 4031))

    def execute(self, sql: str, args: Sequence[Any] = ()) -> Any:
        cur = self._raw.cursor()
        try:
            cur.execute(self._dialect.translate(sql), tuple(args))
        except Exception as err:  # graphlint: ignore[PY001] -- classify-then-reraise: flags connection-level driver errors for the pool, always re-raises
            # Connection-level failures poison the handle; checkout() sees
            # the flag and reconnects on the next operation.
            if self._is_connection_error(err):
                self.broken = True
            raise
        self._touch()
        return cur

    def executemany(self, sql: str, seq: Sequence[Sequence[Any]]) -> Any:
        cur = self._raw.cursor()
        try:
            cur.executemany(self._dialect.translate(sql), [tuple(a) for a in seq])
        except Exception as err:  # graphlint: ignore[PY001] -- classify-then-reraise: flags connection-level driver errors for the pool, always re-raises
            if self._is_connection_error(err):
                self.broken = True
            raise
        self._touch()
        return cur

    def ping(self) -> None:
        raw = self._raw
        if hasattr(raw, "ping"):
            try:
                raw.ping(reconnect=True)  # pymysql signature
                return
            except TypeError:
                raw.ping()
                return
        cur = raw.cursor()
        cur.execute("SELECT 1")
        cur.fetchone()

    def close(self) -> None:
        self._raw.close()


def make_dialect(url: str, engine_kwargs: dict[str, Any] | None = None):
    """URL -> dialect instance. sqlite/bare paths stay on the stdlib driver;
    mysql/postgresql resolve a DBAPI driver (raising with pip + migration
    guidance when none is installed)."""
    if url.startswith("sqlite:///"):
        return SqliteDialect(url[len("sqlite:///"):])
    if url.startswith("rdb:///"):
        return SqliteDialect(url[len("rdb:///"):])
    scheme = url.split("://", 1)[0] if "://" in url else ""
    family = scheme.partition("+")[0]
    if family == "mysql":
        return MySQLDialect(url, engine_kwargs)
    if family in ("postgresql", "postgres"):
        return PostgresDialect(url, engine_kwargs)
    if "://" in url:
        raise ValueError(f"Unrecognized RDB URL scheme: {scheme!r}")
    return SqliteDialect(url)  # bare filesystem path
