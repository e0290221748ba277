"""The batched-objective contract (port of ``VectorizedObjective`` from
``optuna_tpu/parallel/vectorized.py``).

The compiled and guarded dispatch wrappers, ``_pack_params`` and
``optimize_vectorized`` come with the executor (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from optuna_tpu_torch.distributions import BaseDistribution


class VectorizedObjective:
    """A batched objective over an explicit search space.

    ``fn`` maps ``{name: tensor of shape (B,)}`` (internal representations:
    float32 values; categorical params as int32 choice indices) to a
    tensor of shape ``(B,)`` (a ``(B, 1)`` column is accepted).
    ``_compiled_cache`` is a plain per-objective cache: the scan loop keeps
    its per-(pool size, device) device constants there, so their lifetime
    follows the objective. Nothing is compiled.
    """

    def __init__(
        self,
        fn: Callable[[dict[str, torch.Tensor]], torch.Tensor],
        search_space: dict[str, BaseDistribution],
    ) -> None:
        self.fn = fn
        self.search_space = search_space
        self._compiled_cache: dict[tuple, Any] = {}
