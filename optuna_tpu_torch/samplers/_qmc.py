"""Quasi-Monte-Carlo sampler (port of ``optuna_tpu/samplers/_qmc.py``;
reference ``optuna/samplers/_qmc.py:38``). Host only: SciPy's engines, as in
the reference, so the two packages draw the same points bit for bit.

Sobol/Halton low-discrepancy sequences over the transformed search space;
the sample index is derived from the trial count so parallel workers draw
distinct points of the same sequence.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any

import numpy as np

from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.samplers._random import RandomSampler
from optuna_tpu_torch.search_space import IntersectionSearchSpace
from optuna_tpu_torch.transform import SearchSpaceTransform
from optuna_tpu_torch.trial._frozen import FrozenTrial

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)

_threading_lock = threading.Lock()


class QMCSampler(BaseSampler):
    def __init__(
        self,
        *,
        qmc_type: str = "sobol",
        scramble: bool = True,
        seed: int | None = None,
        independent_sampler: BaseSampler | None = None,
        warn_asynchronous_seeding: bool = True,
        warn_independent_sampling: bool = True,
    ) -> None:
        if qmc_type not in ("sobol", "halton"):
            raise ValueError(
                f'The `qmc_type`, "{qmc_type}", is not a valid. '
                'It must be one of "sobol" or "halton".'
            )
        self._qmc_type = qmc_type
        self._scramble = scramble
        if seed is None:
            seed = int(np.random.PCG64().random_raw() % (2**31))
            if warn_asynchronous_seeding:
                _logger.warning(
                    "No seed is provided for `QMCSampler`; distributed workers "
                    "will draw overlapping sequences unless they share a seed."
                )
        self._seed = seed
        self._independent_sampler = independent_sampler or RandomSampler(seed=seed)
        self._warn_independent_sampling = warn_independent_sampling
        self._initial_search_space: dict[str, BaseDistribution] | None = None
        self._search_space = IntersectionSearchSpace(include_pruned=True)
        self._rng = LazyRandomState(seed)

    def reseed_rng(self) -> None:
        self._rng.seed()
        self._independent_sampler.reseed_rng()

    def infer_relative_search_space(
        self, study: "Study", trial: FrozenTrial
    ) -> dict[str, BaseDistribution]:
        if self._initial_search_space is not None:
            return self._initial_search_space
        past_trials = study._get_trials(deepcopy=False, use_cache=True)
        past_trials = [t for t in past_trials if t.state.is_finished()]
        if len(past_trials) == 0:
            return {}
        first_trial = min(past_trials, key=lambda t: t.number)
        space: dict[str, BaseDistribution] = {}
        for name, dist in sorted(first_trial.distributions.items()):
            if dist.single():
                continue
            space[name] = dist
        self._initial_search_space = space
        return space

    def sample_relative(
        self,
        study: "Study",
        trial: FrozenTrial,
        search_space: dict[str, BaseDistribution],
    ) -> dict[str, Any]:
        if search_space == {}:
            return {}
        sample_id = self._find_sample_id(study)
        trans = SearchSpaceTransform(search_space, transform_0_1=True)
        sample = self._sample_qmc(sample_id, len(trans.bounds))
        return trans.untransform(sample)

    def _find_sample_id(self, study: "Study") -> int:
        # The sample index advances with the trial count (reference :303).
        key = f"qmc ({self._qmc_type})"
        with _threading_lock:
            attrs = study._storage.get_study_system_attrs(study._study_id)
            sample_id = attrs.get(key, 0)
            study._storage.set_study_system_attr(study._study_id, key, sample_id + 1)
        return sample_id

    def _sample_qmc(self, sample_id: int, dim: int) -> np.ndarray:
        from scipy.stats import qmc

        with _threading_lock:
            if self._qmc_type == "sobol":
                engine = qmc.Sobol(d=dim, scramble=self._scramble, seed=self._seed)
            else:
                engine = qmc.Halton(d=dim, scramble=self._scramble, seed=self._seed)
            # scipy 1.17's Sobol.fast_forward overflows on scrambled engines;
            # draw-and-discard is equivalent and version-proof.
            import warnings as _warnings

            with _warnings.catch_warnings():
                _warnings.filterwarnings("ignore", message=".*balance properties.*")
                if sample_id > 0:
                    engine.random(sample_id)
                return engine.random(1)[0]

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        if self._initial_search_space is not None and self._warn_independent_sampling:
            _logger.warning(
                f"The parameter '{param_name}' in trial#{trial.number} is sampled "
                "independently instead of by QMCSampler."
            )
        return self._independent_sampler.sample_independent(
            study, trial, param_name, param_distribution
        )
