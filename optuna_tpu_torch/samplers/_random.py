"""Uniform random sampler (reference ``optuna/samplers/_random.py:19-72``).

Independent-only: samples each parameter uniformly in the transformed space
and inverts the transform, which gives log-uniform / grid-uniform behaviour
for free. Host-side NumPy — a single scalar draw per parameter is orchestration,
not compute, so shipping it to the device would only add dispatch latency.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.transform import SearchSpaceTransform
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study


class RandomSampler(BaseSampler):
    def __init__(self, seed: int | None = None) -> None:
        self._rng = LazyRandomState(seed)

    def reseed_rng(self) -> None:
        self._rng.seed()

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        search_space = {param_name: param_distribution}
        trans = SearchSpaceTransform(search_space)
        trans_params = self._rng.rng.uniform(trans.bounds[:, 0], trans.bounds[:, 1])
        return trans.untransform(trans_params)[param_name]
