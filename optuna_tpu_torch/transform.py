"""Search-space <-> real-vector encoding.

Parity target: ``optuna/_transform.py:18`` (``_SearchSpaceTransform``):
one-hot categoricals, log-transform for log domains, half-step widening for
discrete domains, optional [0,1] scaling, exact inverse. This host-side layer
is intentionally NumPy (per-trial scalar work); batched trial histories are
encoded once with :meth:`encode_many` and shipped to the device as a single
dense ``float`` matrix — the boundary where JAX takes over.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np

from optuna_tpu_torch.distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)


class SearchSpaceTransform:
    """Encode a dict of params into a fixed-width real vector and back.

    ``bounds`` is a ``(d, 2)`` array of per-dimension [low, high]. For
    categorical params each choice occupies one [0,1] dimension (one-hot);
    ``untransform`` takes the argmax. Numerical params occupy one dimension,
    log-scaled when the distribution is log, widened by half a step for
    discrete domains so round-tripping hits every grid point with equal mass.
    """

    def __init__(
        self,
        search_space: dict[str, BaseDistribution],
        transform_log: bool = True,
        transform_step: bool = True,
        transform_0_1: bool = False,
    ) -> None:
        self._search_space = search_space
        self._transform_log = transform_log
        self._transform_step = transform_step
        self._transform_0_1 = transform_0_1

        n_dims = 0
        column_to_encoded_columns: list[np.ndarray] = []
        encoded_column_to_column: list[int] = []
        for i, dist in enumerate(search_space.values()):
            if isinstance(dist, CategoricalDistribution):
                n_choices = len(dist.choices)
                column_to_encoded_columns.append(np.arange(n_dims, n_dims + n_choices))
                encoded_column_to_column.extend([i] * n_choices)
                n_dims += n_choices
            else:
                column_to_encoded_columns.append(np.array([n_dims]))
                encoded_column_to_column.append(i)
                n_dims += 1

        self.column_to_encoded_columns = column_to_encoded_columns
        self.encoded_column_to_column = np.array(encoded_column_to_column, dtype=np.int64)

        bounds = np.empty((n_dims, 2), dtype=np.float64)
        k = 0
        for dist in search_space.values():
            if isinstance(dist, CategoricalDistribution):
                for _ in dist.choices:
                    bounds[k] = (0.0, 1.0)
                    k += 1
            else:
                bounds[k] = self._numerical_bounds(dist)
                k += 1
        if transform_0_1:
            self._raw_bounds = bounds.copy()
            bounds = np.tile(np.array([0.0, 1.0]), (n_dims, 1))
        else:
            self._raw_bounds = bounds
        self._bounds = bounds

    @property
    def bounds(self) -> np.ndarray:
        return self._bounds

    # ---------------------------------------------------------------- encode

    def _numerical_bounds(self, dist: BaseDistribution) -> tuple[float, float]:
        assert isinstance(dist, (FloatDistribution, IntDistribution))
        low: float = dist.low
        high: float = dist.high
        step = getattr(dist, "step", None)
        if dist.log and self._transform_log:
            if step is not None and self._transform_step and isinstance(dist, IntDistribution):
                # log-int: half-step widen in the raw domain then log.
                low = math.log(low - 0.5)
                high = math.log(high + 0.5)
            else:
                low = math.log(low)
                high = math.log(high)
        elif step is not None and self._transform_step:
            half = 0.5 * float(step)
            low = low - half
            high = high + half
        return low, high

    def _transform_numerical(self, dist: BaseDistribution, value: float) -> float:
        if dist.log and self._transform_log:
            return math.log(value)
        return float(value)

    def transform(self, params: dict[str, Any]) -> np.ndarray:
        """Encode one param dict to a ``(d,)`` vector."""
        vec = np.zeros(len(self._bounds), dtype=np.float64)
        k = 0
        for name, dist in self._search_space.items():
            if isinstance(dist, CategoricalDistribution):
                n = len(dist.choices)
                choice_index = int(dist.to_internal_repr(params[name]))
                vec[k + choice_index] = 1.0
                k += n
            else:
                v = self._transform_numerical(dist, float(params[name]))
                if self._transform_0_1:
                    lo, hi = self._raw_bounds[k]
                    v = 0.5 if hi == lo else (v - lo) / (hi - lo)
                vec[k] = v
                k += 1
        return vec

    def encode_many(self, params_list: Sequence[dict[str, Any]]) -> np.ndarray:
        """Encode a trial history into an ``(n, d)`` matrix (device-bound batch)."""
        out = np.empty((len(params_list), len(self._bounds)), dtype=np.float64)
        for i, params in enumerate(params_list):
            out[i] = self.transform(params)
        return out

    # -------------------------------------------------------------- decode

    def untransform(self, trans_params: np.ndarray) -> dict[str, Any]:
        """Exact inverse of :meth:`transform` with clipping back into bounds."""
        assert trans_params.shape == (len(self._bounds),)
        params: dict[str, Any] = {}
        for (name, dist), enc_cols in zip(
            self._search_space.items(), self.column_to_encoded_columns
        ):
            if isinstance(dist, CategoricalDistribution):
                index = int(np.argmax(trans_params[enc_cols]))
                params[name] = dist.to_external_repr(float(index))
            else:
                k = int(enc_cols[0])
                v = float(trans_params[k])
                if self._transform_0_1:
                    lo, hi = self._raw_bounds[k]
                    v = lo + v * (hi - lo)
                params[name] = self._untransform_numerical(dist, v)
        return params

    def _untransform_numerical(self, dist: BaseDistribution, value: float) -> Any:
        if dist.log and self._transform_log:
            value = math.exp(value)
        if isinstance(dist, IntDistribution):
            if dist.step is not None and self._transform_step:
                value = dist.low + dist.step * round((value - dist.low) / dist.step)
            v = int(np.clip(round(value), dist.low, dist.high))
            # keep on the step grid after clipping
            v = dist.low + ((v - dist.low) // dist.step) * dist.step
            return int(v)
        assert isinstance(dist, FloatDistribution)
        if dist.step is not None and self._transform_step:
            value = dist.low + dist.step * round((value - dist.low) / dist.step)
        return float(np.clip(value, dist.low, dist.high))
