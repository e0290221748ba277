"""GP-internal search-space encoding: normalized [0,1] dims + categorical indices.

Parity target: ``optuna/_gp/search_space.py:36`` (scale types LINEAR/LOG/
CATEGORICAL, steps, normalized-point sampling). Numerical params normalize to
[0, 1] (log domains in log space); discrete params keep their normalized step
so the optimizer can enumerate/round; categorical dims carry the raw choice
index and are compared by Hamming distance inside the kernel.
"""

from __future__ import annotations

import enum
import math
from typing import Any

import numpy as np

from optuna_tpu_torch.distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)


class ScaleType(enum.IntEnum):
    LINEAR = 0
    LOG = 1
    CATEGORICAL = 2


class SearchSpace:
    """Vectorized description of a (sorted-name) search space for GP use."""

    def __init__(self, search_space: dict[str, BaseDistribution]) -> None:
        self._search_space = search_space
        self.param_names = list(search_space.keys())
        d = len(self.param_names)
        self.scale_types = np.zeros(d, dtype=np.int64)
        self.bounds = np.zeros((d, 2), dtype=np.float64)  # raw (possibly log) bounds
        self.steps = np.zeros(d, dtype=np.float64)  # normalized step; 0 => continuous
        self.n_choices = np.zeros(d, dtype=np.int64)  # >0 only for categorical

        for i, (name, dist) in enumerate(search_space.items()):
            if isinstance(dist, CategoricalDistribution):
                self.scale_types[i] = ScaleType.CATEGORICAL
                self.n_choices[i] = len(dist.choices)
                self.bounds[i] = (0.0, float(len(dist.choices)))
            else:
                assert isinstance(dist, (FloatDistribution, IntDistribution))
                if dist.log:
                    self.scale_types[i] = ScaleType.LOG
                    lo = math.log(dist.low - 0.5) if isinstance(dist, IntDistribution) else math.log(dist.low)
                    hi = math.log(dist.high + 0.5) if isinstance(dist, IntDistribution) else math.log(dist.high)
                    self.bounds[i] = (lo, hi)
                    # log-ints round at decode; treat as continuous in-model.
                    self.steps[i] = 0.0
                else:
                    self.scale_types[i] = ScaleType.LINEAR
                    if isinstance(dist, IntDistribution):
                        lo, hi = dist.low - 0.5 * dist.step, dist.high + 0.5 * dist.step
                        step = float(dist.step)
                    else:
                        step = float(dist.step) if dist.step is not None else 0.0
                        if step > 0:
                            lo, hi = dist.low - 0.5 * step, dist.high + 0.5 * step
                        else:
                            lo, hi = dist.low, dist.high
                    self.bounds[i] = (lo, hi)
                    width = hi - lo
                    self.steps[i] = step / width if (step > 0 and width > 0) else 0.0

    @property
    def dim(self) -> int:
        return len(self.param_names)

    @property
    def is_categorical(self) -> np.ndarray:
        return self.scale_types == ScaleType.CATEGORICAL

    # -------------------------------------------------------------- transforms

    def normalize_one(self, params: dict[str, Any]) -> np.ndarray:
        out = np.zeros(self.dim, dtype=np.float64)
        for i, name in enumerate(self.param_names):
            dist = self._search_space[name]
            v = params[name]
            if self.scale_types[i] == ScaleType.CATEGORICAL:
                out[i] = dist.to_internal_repr(v)  # choice index
            else:
                raw = float(dist.to_internal_repr(v))
                if self.scale_types[i] == ScaleType.LOG:
                    raw = math.log(raw)
                lo, hi = self.bounds[i]
                out[i] = 0.5 if hi == lo else (raw - lo) / (hi - lo)
        return out

    def normalize(self, params_list: list[dict[str, Any]]) -> np.ndarray:
        """(n, d) normalized matrix — the device-bound batch encode."""
        out = np.empty((len(params_list), self.dim), dtype=np.float64)
        for i, p in enumerate(params_list):
            out[i] = self.normalize_one(p)
        return out

    def unnormalize_one(self, x: np.ndarray) -> dict[str, Any]:
        """Normalized vector -> external param dict (inverse of normalize_one)."""
        params: dict[str, Any] = {}
        for i, name in enumerate(self.param_names):
            dist = self._search_space[name]
            if self.scale_types[i] == ScaleType.CATEGORICAL:
                params[name] = dist.to_external_repr(float(int(round(float(x[i])))))
                continue
            lo, hi = self.bounds[i]
            raw = lo + float(np.clip(x[i], 0.0, 1.0)) * (hi - lo)
            if self.scale_types[i] == ScaleType.LOG:
                raw = math.exp(raw)
            if isinstance(dist, IntDistribution):
                v = dist.low + dist.step * round((raw - dist.low) / dist.step)
                v = int(np.clip(v, dist.low, dist.high))
                v = dist.low + ((v - dist.low) // dist.step) * dist.step
                params[name] = dist.to_external_repr(float(v))
            else:
                assert isinstance(dist, FloatDistribution)
                if dist.step is not None:
                    raw = dist.low + dist.step * round((raw - dist.low) / dist.step)
                params[name] = float(np.clip(raw, dist.low, dist.high))
        return params

    def sample_normalized(self, n: int, seed: int | None = None) -> np.ndarray:
        """Scrambled-Sobol candidates: [0,1] for numerical dims (snapped to the
        step grid for discrete), uniform choice index for categorical dims
        (reference ``search_space.py:171-194``)."""
        from optuna_tpu_torch.ops.qmc import sobol_sample

        pts = sobol_sample(n, self.dim, seed)
        for i in range(self.dim):
            if self.scale_types[i] == ScaleType.CATEGORICAL:
                pts[:, i] = np.floor(pts[:, i] * self.n_choices[i]).clip(
                    0, self.n_choices[i] - 1
                )
            elif self.steps[i] > 0:
                pts[:, i] = _round_to_step_grid(pts[:, i], self.steps[i])
        return pts


def _round_to_step_grid(x: np.ndarray, step: float) -> np.ndarray:
    """Snap normalized values onto the centers {step/2 + k*step}."""
    return np.clip(step * (np.floor(x / step) + 0.5), 0.0, 1.0)
