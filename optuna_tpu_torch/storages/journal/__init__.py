"""Journal storages (port of ``optuna_tpu/storages/journal/__init__.py``;
reference ``optuna/storages/journal/__init__.py``)."""

from optuna_tpu_torch.storages.journal._base import BaseJournalBackend
from optuna_tpu_torch.storages.journal._file import (
    JournalFileBackend,
    JournalFileOpenLock,
    JournalFileSymlinkLock,
)
from optuna_tpu_torch.storages.journal._storage import JournalStorage

__all__ = [
    "BaseJournalBackend",
    "JournalFileBackend",
    "JournalFileOpenLock",
    "JournalFileSymlinkLock",
    "JournalRedisBackend",
    "JournalStorage",
]


def __getattr__(name: str):
    if name == "JournalRedisBackend":
        from optuna_tpu_torch.storages.journal._redis import JournalRedisBackend

        return JournalRedisBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
