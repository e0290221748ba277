"""Gaussian-process core of the port (reference ``optuna_tpu/gp``)."""

from optuna_tpu_torch.gp.gp import GPParams, GPState, fit_gp, posterior
from optuna_tpu_torch.gp.search_space import ScaleType, SearchSpace

__all__ = ["GPParams", "GPState", "ScaleType", "SearchSpace", "fit_gp", "posterior"]
