"""Mean-decrease-impurity importance (reference
``optuna/importance/_mean_decrease_impurity.py``): the random forest's own
impurity-decrease importances, one-hot columns collapsed per parameter.
The forest is the histogram forest (:mod:`optuna_tpu_torch.ops.forest`) on
``device``;
the reference wraps sklearn's ``feature_importances_``."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np

from optuna_tpu_torch.importance._base import BaseImportanceEvaluator
from optuna_tpu_torch.importance._evaluate import _get_filtered_trials, _target_values
from optuna_tpu_torch.transform import SearchSpaceTransform

if TYPE_CHECKING:
    import torch

    from optuna_tpu_torch.study.study import Study


class MeanDecreaseImpurityImportanceEvaluator(BaseImportanceEvaluator):
    def __init__(
        self,
        *,
        n_trees: int = 64,
        max_depth: int = 64,
        seed: int | None = None,
        device: "str | torch.device | None" = None,
    ) -> None:
        self._n_trees = n_trees
        self._max_depth = max_depth
        self._seed = seed
        self._device = device  # where the forest grows; None: the card

    def evaluate(
        self,
        study: "Study",
        params: list[str] | None = None,
        *,
        target: Callable | None = None,
    ) -> dict[str, float]:
        from optuna_tpu_torch.ops.forest import fit_forest, forest_feature_importances

        trials, params = _get_filtered_trials(study, params, target)
        space = {p: trials[0].distributions[p] for p in params}
        trans = SearchSpaceTransform(space, transform_log=True, transform_step=True, transform_0_1=True)
        X = trans.encode_many([t.params for t in trials])
        y = _target_values(trials, target)

        trees = fit_forest(
            X, y, n_trees=self._n_trees, max_depth=self._max_depth, seed=self._seed,
            device=self._device,
        )
        feat = forest_feature_importances(trees, X.shape[1])

        importances = {p: 0.0 for p in params}
        for enc_col, col in enumerate(trans.encoded_column_to_column):
            importances[params[int(col)]] += float(feat[enc_col])
        return dict(sorted(importances.items(), key=lambda kv: kv[1], reverse=True))
