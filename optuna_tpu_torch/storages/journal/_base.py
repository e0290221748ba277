"""Journal backend protocol (port of ``optuna_tpu/storages/journal/_base.py``;
reference ``optuna/storages/journal/_base.py``)."""

from __future__ import annotations

import abc
from typing import Any


class BaseJournalBackend(abc.ABC):
    """Append-only log of JSON-serializable operations."""

    @abc.abstractmethod
    def read_logs(self, log_number_from: int) -> list[dict[str, Any]]:
        """All log entries with index >= log_number_from."""
        raise NotImplementedError

    @abc.abstractmethod
    def append_logs(self, logs: list[dict[str, Any]]) -> None:
        raise NotImplementedError

    # Snapshot hooks are optional (reference BaseJournalSnapshot).
    def save_snapshot(self, snapshot: bytes) -> None:
        pass

    def load_snapshot(self) -> bytes | None:
        return None
