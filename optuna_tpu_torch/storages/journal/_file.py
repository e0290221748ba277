"""Append-only JSONL file backend with NFS-safe locking (port of
``optuna_tpu/storages/journal/_file.py``).

Parity target: ``optuna/storages/journal/_file.py`` — fsync'd appends
(``:103``), byte-offset incremental reads with torn-write tolerance
(``:66-111``), and two NFS-safe lock flavours: symlink locks (``:124``) and
O_EXCL open locks (``:215``), both with grace-period takeover so a crashed
worker cannot wedge the file forever.
"""

from __future__ import annotations

import abc
import errno
import json
import os
import struct
import time
import uuid
import zlib
from typing import Any

from optuna_tpu_torch import telemetry
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages.journal._base import BaseJournalBackend

_logger = get_logger(__name__)

LOCK_FILE_SUFFIX = ".lock"
RENAME_FILE_SUFFIX = ".rename"

#: Snapshot framing: magic + little-endian CRC32 of the payload, prepended
#: by :func:`frame_snapshot` and verified by :func:`unframe_snapshot`. A
#: snapshot is a pure replay optimization, so integrity failures (torn
#: write, bit rot, a pre-CRC legacy file) degrade to "no snapshot" — full
#: journal replay — instead of feeding corrupt bytes to ``pickle.loads``,
#: whose failure modes on garbage range far outside ``UnpicklingError``.
SNAPSHOT_MAGIC = b"OTSNAP1\n"
_SNAPSHOT_CRC_STRUCT = struct.Struct("<I")


def frame_snapshot(payload: bytes) -> bytes:
    """Prepend the magic + CRC32 header to a raw snapshot payload."""
    return SNAPSHOT_MAGIC + _SNAPSHOT_CRC_STRUCT.pack(zlib.crc32(payload)) + payload


def unframe_snapshot(data: bytes | None, *, source: str) -> bytes | None:
    """Verify and strip the snapshot frame; None when absent or corrupt.

    Checksum-before-unpickle: the caller can narrow its unpickling guard to
    ``pickle.UnpicklingError`` (version drift) because corrupt *bytes* are
    caught here, by CRC, and reported as a missing snapshot.
    """
    if data is None:
        return None
    header = len(SNAPSHOT_MAGIC) + _SNAPSHOT_CRC_STRUCT.size
    if len(data) < header or not data.startswith(SNAPSHOT_MAGIC):
        # Name the defect precisely: a replay-from-logs decision should be
        # debuggable from the log line alone (what was there vs. expected).
        _logger.warning(
            f"Journal snapshot at {source} lacks the CRC header: got "
            f"{len(data)} bytes, need >= {header} starting with "
            f"{SNAPSHOT_MAGIC!r} (found {data[:len(SNAPSHOT_MAGIC)]!r}). "
            "Legacy or corrupt snapshot; ignoring it and replaying the "
            "journal from its logs instead."
        )
        return None
    (expected,) = _SNAPSHOT_CRC_STRUCT.unpack_from(data, len(SNAPSHOT_MAGIC))
    payload = data[header:]
    computed = zlib.crc32(payload)
    if computed != expected:
        _logger.warning(
            f"Journal snapshot at {source} failed its CRC32 check: payload "
            f"of {len(payload)} bytes at offset {header} computed "
            f"0x{computed:08x}, header claims 0x{expected:08x} (torn write "
            "or corruption). Ignoring it and replaying the journal from "
            "its logs instead."
        )
        return None
    return payload


def _steal_stale_lock(lockfile: str, grace_period: float) -> bool:
    """Atomically break a stale lock. Renaming the lockfile to a unique name
    succeeds for exactly one waiter, so two waiters that both observed the
    lock expired cannot each unlink the other's freshly created lock — the
    loser's rename fails with ENOENT and it goes back to waiting. Returns
    True iff this caller won the steal. The lock is re-checked under the
    unique name before removal so a fresh lock is never broken."""
    stolen = lockfile + ".stale." + uuid.uuid4().hex[:12]
    try:
        os.rename(lockfile, stolen)
    except OSError:
        return False  # someone else stole (or released) it first
    try:
        st = os.lstat(stolen)
        if time.time() - st.st_mtime <= grace_period:
            # Raced with a release+acquire: the lock we grabbed is fresh and
            # its owner is alive. Restore it with link() — which fails with
            # EEXIST instead of clobbering — so a lock some third waiter
            # created in the meantime is never silently overwritten.
            try:
                os.link(stolen, lockfile, follow_symlinks=False)
            except OSError:
                _logger.error(
                    f"Lock takeover race on {lockfile}: a live lock was displaced and"
                    " could not be restored; two holders may briefly coexist."
                )
            try:
                os.unlink(stolen)
            except OSError:
                pass
            return False
    except OSError:
        pass
    try:
        os.unlink(stolen)
    except OSError:
        pass
    return True


class BaseJournalFileLock(abc.ABC):
    #: Hard wall on one acquire() call — a wedged lock fails loudly, never hangs.
    _ACQUIRE_TIMEOUT = 300.0

    @abc.abstractmethod
    def acquire(self) -> bool:
        raise NotImplementedError

    @abc.abstractmethod
    def release(self) -> None:
        raise NotImplementedError

    def _acquire_with_takeover(self, try_lock) -> bool:
        """Shared acquire loop for both lock primitives: try, steal stale
        locks past the grace period, and back off with full jitter between
        polls (the :class:`~optuna_tpu_torch.storages._retry.RetryPolicy` schedule —
        jitter decorrelates a herd of workers hammering one NFS lockfile).

        ``try_lock`` returns True on success, False while the lock is held,
        and raises on real errors.
        """
        from optuna_tpu_torch.storages._retry import RetryPolicy

        schedule = RetryPolicy(initial_backoff=0.002, max_backoff=0.05, multiplier=1.5)
        attempt = 0
        start = time.time()
        contended = False
        while True:
            if try_lock():
                self._owns = True
                return True
            if not contended:
                # Counted once per contended acquire (not per poll): the
                # metric tracks how often workers collide on the journal
                # lock, not how long each collision lasted — the span-level
                # storage.op latency already carries the waiting time.
                contended = True
                telemetry.count("journal.lock_contention")
            # The timeout gates EVERY path, including repeated takeover
            # attempts — a steal that keeps failing (filesystem flipped
            # read-only under a stale lock) must raise, not spin.
            if time.time() - start > self._ACQUIRE_TIMEOUT:
                raise TimeoutError(
                    f"Could not acquire {self._lockfile} in {self._ACQUIRE_TIMEOUT:.0f}s."
                )
            if self._grace_period is not None and self._lock_expired():
                # Grace-period takeover: a dead worker's stale lock is
                # broken after grace_period seconds.
                if _steal_stale_lock(self._lockfile, self._grace_period):
                    _logger.warning(
                        f"Lock {self._lockfile} expired (> {self._grace_period}s);"
                        " taking over."
                    )
                    continue  # we freed it — grab it before anyone else
            attempt += 1
            time.sleep(schedule.next_delay(attempt))

    def __enter__(self) -> None:
        self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class JournalFileSymlinkLock(BaseJournalFileLock):
    """Atomic ``symlink()`` as the lock primitive — works on NFS where
    O_EXCL historically did not (reference ``:124``)."""

    def __init__(self, filepath: str, grace_period: float = 30.0) -> None:
        self._lock_target_file = filepath
        self._lockfile = filepath + LOCK_FILE_SUFFIX
        self._grace_period = grace_period
        self._owns = False

    def acquire(self) -> bool:
        def try_lock() -> bool:
            try:
                os.symlink(self._lock_target_file, self._lockfile)
                return True
            except OSError as err:
                if err.errno in (errno.EEXIST, errno.EACCES):
                    return False
                raise

        return self._acquire_with_takeover(try_lock)

    def _lock_expired(self) -> bool:
        try:
            st = os.lstat(self._lockfile)
            return time.time() - st.st_mtime > self._grace_period
        except OSError:
            return False

    def release(self) -> None:
        if self._owns:
            self._owns = False
            try:
                os.unlink(self._lockfile)
            except OSError:
                _logger.warning(f"Lock file {self._lockfile} was already removed.")


class JournalFileOpenLock(BaseJournalFileLock):
    """``open(..., O_CREAT|O_EXCL)`` lock (reference ``:215``)."""

    def __init__(self, filepath: str, grace_period: float = 30.0) -> None:
        self._lockfile = filepath + LOCK_FILE_SUFFIX
        self._grace_period = grace_period
        self._owns = False

    def acquire(self) -> bool:
        def try_lock() -> bool:
            try:
                fd = os.open(self._lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                return True
            except OSError as err:
                if err.errno == errno.EEXIST:
                    return False
                raise

        return self._acquire_with_takeover(try_lock)

    def _lock_expired(self) -> bool:
        try:
            st = os.stat(self._lockfile)
            return time.time() - st.st_mtime > self._grace_period
        except OSError:
            return False

    def release(self) -> None:
        if self._owns:
            self._owns = False
            try:
                os.unlink(self._lockfile)
            except OSError:
                _logger.warning(f"Lock file {self._lockfile} was already removed.")


class JournalFileBackend(BaseJournalBackend):
    """JSONL journal file; every append is locked + fsync'd; reads are
    incremental from a remembered byte offset; a torn (unterminated or
    unparseable) final line is ignored and healed on the next append."""

    def __init__(self, file_path: str, lock_obj: BaseJournalFileLock | None = None) -> None:
        self._file_path = file_path
        self._lock = lock_obj or JournalFileSymlinkLock(file_path)
        open(file_path, "ab").close()  # ensure existence
        self._log_number_offset: dict[int, int] = {0: 0}
        self._snapshot_path = file_path + ".snapshot"

    def read_logs(self, log_number_from: int) -> list[dict[str, Any]]:
        logs: list[dict[str, Any]] = []
        with open(self._file_path, "rb") as f:
            # Resume from the deepest known offset at or below the requested
            # log number.
            known = [n for n in self._log_number_offset if n <= log_number_from]
            start_number = max(known) if known else 0
            f.seek(self._log_number_offset[start_number])
            number = start_number
            while True:
                offset = f.tell()
                line = f.readline()
                if not line:
                    break
                if not line.endswith(b"\n"):
                    # Torn write in progress: ignore; the writer will heal it.
                    break
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    # Corrupt (merged/partial) record: advance the byte offset
                    # WITHOUT advancing the log number, so every reader counts
                    # exactly the valid records and replay stays in lockstep.
                    _logger.warning(
                        f"Skipping corrupt journal record at byte {offset} of {self._file_path}."
                    )
                    self._log_number_offset[number] = f.tell()
                    continue
                number += 1
                self._log_number_offset[number] = f.tell()
                if number > log_number_from:
                    logs.append(entry)
        return logs

    def append_logs(self, logs: list[dict[str, Any]]) -> None:
        with self._lock:
            with open(self._file_path, "ab") as f:
                f.seek(0, os.SEEK_END)
                # Heal a torn tail: ensure we start on a record boundary.
                if f.tell() > 0:
                    with open(self._file_path, "rb") as check:
                        check.seek(-1, os.SEEK_END)
                        if check.read(1) != b"\n":
                            f.write(b"\n")
                payload = b"".join(
                    json.dumps(log, separators=(",", ":")).encode() + b"\n" for log in logs
                )
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())

    def save_snapshot(self, snapshot: bytes) -> None:
        tmp = self._snapshot_path + f".{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(frame_snapshot(snapshot))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path)

    def load_snapshot(self) -> bytes | None:
        try:
            with open(self._snapshot_path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        payload = unframe_snapshot(data, source=self._snapshot_path)
        if payload is None:
            # Bytes existed on disk but failed integrity: that is a rejected
            # snapshot (counted), not a missing one (silent). The counter
            # lives at the consumer, not in unframe_snapshot, because the
            # checkpoint module reuses the framing and must not pollute the
            # journal's rejection metric.
            telemetry.count("journal.snapshot_rejected")
        return payload
