"""Samplers package (reference ``optuna_tpu/samplers/__init__.py``).

Every sampler but the base, Random and LazyRandomState loads lazily, so
that importing the package does no numerical set-up.
"""

from __future__ import annotations

from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers._random import RandomSampler

_LAZY = {
    "BaseGASampler": "optuna_tpu_torch.samplers._ga._base",
    "BruteForceSampler": "optuna_tpu_torch.samplers._brute_force",
    "CmaEsSampler": "optuna_tpu_torch.samplers._cmaes",
    "GPSampler": "optuna_tpu_torch.samplers._gp.sampler",
    "GridSampler": "optuna_tpu_torch.samplers._grid",
    "GuardedSampler": "optuna_tpu_torch.samplers._resilience",
    "MOTPESampler": "optuna_tpu_torch.samplers._tpe.sampler",
    "NSGAIISampler": "optuna_tpu_torch.samplers.nsgaii",
    "NSGAIIISampler": "optuna_tpu_torch.samplers._nsgaiii",
    "PartialFixedSampler": "optuna_tpu_torch.samplers._partial_fixed",
    "QMCSampler": "optuna_tpu_torch.samplers._qmc",
    "TPESampler": "optuna_tpu_torch.samplers._tpe.sampler",
    "ThinClientSampler": "optuna_tpu_torch.storages._grpc.suggest_service",
}

__all__ = ["BaseSampler", "LazyRandomState", "RandomSampler", *sorted(_LAZY)]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_LAZY))
