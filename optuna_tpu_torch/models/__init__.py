"""Benchmark objective functions and example models (BASELINE.md configs).

What the port has of the reference's exports (``optuna_tpu/models/__init__.py``):
the trial objectives, ``hartmann6_torch`` in place of ``hartmann6_jax``,
and :mod:`mlp`, config #5's model. The ``*_jax`` variants of Branin and
Rastrigin have no port.
"""

from optuna_tpu_torch.models import mlp
from optuna_tpu_torch.models.benchmarks import (
    branin,
    hartmann6,
    hartmann6_torch,
    rastrigin,
    zdt1,
    zdt2,
    zdt3,
)

__all__ = [
    "branin",
    "hartmann6",
    "hartmann6_torch",
    "mlp",
    "rastrigin",
    "zdt1",
    "zdt2",
    "zdt3",
]
