from optuna_tpu_torch.samplers.nsgaii._crossovers import (
    BLXAlphaCrossover,
    BaseCrossover,
    SBXCrossover,
    SPXCrossover,
    UNDXCrossover,
    UniformCrossover,
    VSBXCrossover,
)
from optuna_tpu_torch.samplers.nsgaii._mutations import BaseMutation, PolynomialMutation
from optuna_tpu_torch.samplers.nsgaii._sampler import NSGAIISampler

__all__ = [
    "BLXAlphaCrossover",
    "BaseCrossover",
    "BaseMutation",
    "NSGAIISampler",
    "PolynomialMutation",
    "SBXCrossover",
    "SPXCrossover",
    "UNDXCrossover",
    "UniformCrossover",
    "VSBXCrossover",
]
