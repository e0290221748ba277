"""Storages package (port of ``optuna_tpu/storages/__init__.py``).

The in-memory backend and the storage wrappers: the retrying wrapper, the
read cache, the heartbeat machinery and the failed-trial retry callbacks.
The RDB, journal and gRPC backends wait for ROADMAP A8, so a storage URL
raises.
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
    "BaseStorage",
    "InMemoryStorage",
    "RetryFailedTrialCallback",
    "RetryHeartbeatStaleTrialCallback",
    "RetryPolicy",
    "RetryingStorage",
    "TransientStorageError",
    "_CachedStorage",
    "fail_stale_trials",
    "get_storage",
]


def get_storage(storage: Union[None, str, BaseStorage]) -> BaseStorage:
    """Resolve a storage spec: None -> fresh in-memory; a storage passes through."""
    if storage is None:
        return InMemoryStorage()
    if isinstance(storage, BaseStorage):
        return storage
    if isinstance(storage, str):
        raise NotImplementedError(
            f"Storage URL {storage!r}: only in-memory storage is ported so far "
            "(ROADMAP.md item A8)."
        )
    raise ValueError(f"Unsupported storage type: {type(storage)!r}")
