"""Fork-safe lazily-created RNG (reference ``optuna/samplers/_lazy_random_state.py``).

Host-side scalar sampling uses ``numpy.random.RandomState`` created on first
touch so that process forks after sampler construction don't share streams.
Device-side draws use ``torch.Generator``s seeded from this RNG on demand.
"""

from __future__ import annotations

import numpy as np


class LazyRandomState:
    def __init__(self, seed: int | None = None) -> None:
        self._seed = seed
        self._rng: np.random.RandomState | None = None

    @property
    def rng(self) -> np.random.RandomState:
        if self._rng is None:
            self._rng = np.random.RandomState(self._seed)
        return self._rng

    @rng.setter
    def rng(self, value: np.random.RandomState) -> None:
        self._rng = value

    def seed(self, seed: int | None = None) -> None:
        self._seed = seed
        self._rng = np.random.RandomState(seed)
