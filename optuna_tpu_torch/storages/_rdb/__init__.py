"""Relational storage (port of ``optuna_tpu/storages/_rdb``)."""

from optuna_tpu_torch.storages._rdb.storage import RDBStorage

__all__ = ["RDBStorage"]
