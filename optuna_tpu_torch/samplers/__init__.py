"""Samplers package (reference ``optuna_tpu/samplers/__init__.py``).

GPSampler loads lazily so that importing the package does no numerical
set-up.
"""

from __future__ import annotations

from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers._random import RandomSampler

__all__ = ["BaseSampler", "GPSampler", "LazyRandomState", "RandomSampler"]


def __getattr__(name: str):
    if name == "GPSampler":
        from optuna_tpu_torch.samplers._gp.sampler import GPSampler

        return GPSampler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list[str]:
    return sorted(set(globals()) | {"GPSampler"})
