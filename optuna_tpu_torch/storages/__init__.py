"""Storages package: URL -> backend dispatch (port of
``optuna_tpu/storages/__init__.py``; reference
``optuna/storages/__init__.py:22-55``).

The in-memory backend, the relational backend over ``sqlite3`` (with the
MySQL and PostgreSQL dialects over any DB-API driver), the journal backends
(file and Redis), and the storage wrappers: the retrying wrapper, the read
cache, the heartbeat machinery, the failed-trial retry callbacks, and the
gRPC storage proxy (``grpc://host:port``; its client and server import
``grpc`` only when used).
"""

from __future__ import annotations

from typing import Union

from optuna_tpu_torch.storages._base import BaseStorage
from optuna_tpu_torch.storages._cached_storage import _CachedStorage
from optuna_tpu_torch.storages._callbacks import (
    RetryFailedTrialCallback,
    RetryHeartbeatStaleTrialCallback,
)
from optuna_tpu_torch.storages._heartbeat import BaseHeartbeat, fail_stale_trials
from optuna_tpu_torch.storages._in_memory import InMemoryStorage
from optuna_tpu_torch.storages._retry import (
    RetryingStorage,
    RetryPolicy,
    TransientStorageError,
)

__all__ = [
    "BaseHeartbeat",
    "BaseJournalLogStorage",
    "BaseStorage",
    "GrpcStorageProxy",
    "InMemoryStorage",
    "JournalFileOpenLock",
    "JournalFileStorage",
    "JournalFileSymlinkLock",
    "JournalRedisStorage",
    "JournalStorage",
    "RDBStorage",
    "RetryFailedTrialCallback",
    "RetryHeartbeatStaleTrialCallback",
    "RetryPolicy",
    "RetryingStorage",
    "TransientStorageError",
    "_CachedStorage",
    "fail_stale_trials",
    "get_storage",
    "run_grpc_proxy_server",
]

_LAZY = {
    # Deprecated drop-in names from the reference (pre-journal-package API).
    "BaseJournalLogStorage": ("optuna_tpu_torch.storages.journal._base", "BaseJournalBackend"),
    "JournalFileStorage": ("optuna_tpu_torch.storages.journal._file", "JournalFileBackend"),
    "JournalRedisStorage": ("optuna_tpu_torch.storages.journal._redis", "JournalRedisBackend"),
    "JournalFileOpenLock": ("optuna_tpu_torch.storages.journal._file", "JournalFileOpenLock"),
    "JournalFileSymlinkLock": ("optuna_tpu_torch.storages.journal._file", "JournalFileSymlinkLock"),
    "journal": ("optuna_tpu_torch.storages.journal", None),
    "RDBStorage": ("optuna_tpu_torch.storages._rdb.storage", "RDBStorage"),
    "JournalStorage": ("optuna_tpu_torch.storages.journal", "JournalStorage"),
    "JournalFileBackend": ("optuna_tpu_torch.storages.journal", "JournalFileBackend"),
    "GrpcStorageProxy": ("optuna_tpu_torch.storages._grpc.client", "GrpcStorageProxy"),
    "run_grpc_proxy_server": ("optuna_tpu_torch.storages._grpc.server", "run_grpc_proxy_server"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        mod = importlib.import_module(module)
        return mod if attr is None else getattr(mod, attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_storage(storage: Union[None, str, BaseStorage]) -> BaseStorage:
    """Resolve a storage spec: None -> fresh in-memory; URL string -> backend.

    RDB URLs are wrapped in ``_CachedStorage`` exactly as the reference does
    (``optuna/storages/__init__.py:41-55``).
    """
    if storage is None:
        return InMemoryStorage()
    if isinstance(storage, str):
        if storage.startswith(
            ("sqlite://", "rdb://", "mysql://", "mysql+", "postgresql://",
             "postgresql+", "postgres://", "postgres+")
        ):
            from optuna_tpu_torch.storages._rdb.storage import RDBStorage

            return _CachedStorage(RDBStorage(storage))
        if storage.startswith("journal://") or storage.endswith(".journal"):
            from optuna_tpu_torch.storages.journal import JournalFileBackend, JournalStorage

            path = storage[len("journal://"):] if storage.startswith("journal://") else storage
            return JournalStorage(JournalFileBackend(path))
        if storage.startswith("grpc://"):
            from optuna_tpu_torch.storages._grpc.client import GrpcStorageProxy

            hostport = storage[len("grpc://"):]
            host, _, port = hostport.partition(":")
            # Cached wrap: sampler history reads poll the proxy incrementally
            # (_read_trials_partial) instead of shipping the full trial list.
            return _CachedStorage(
                GrpcStorageProxy(host=host or "localhost", port=int(port or 13000))
            )
        raise ValueError(f"Unrecognized storage URL: {storage!r}")
    if isinstance(storage, BaseStorage):
        return storage
    raise ValueError(f"Unsupported storage type: {type(storage)!r}")


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_LAZY))
