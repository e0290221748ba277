"""Storages package: in-memory only in this slice (reference
``optuna_tpu/storages/__init__.py``; RDB, journal and gRPC backends wait)."""

from __future__ import annotations

from typing import Union

from optuna_tpu_torch.storages._base import BaseStorage
from optuna_tpu_torch.storages._in_memory import InMemoryStorage

__all__ = ["BaseStorage", "InMemoryStorage", "get_storage"]


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
