"""fANOVA importance: random forest + exact per-tree marginal variance.

Parity target: ``optuna/importance/_fanova/`` — a random-forest fit
over the transformed space (the reference wraps sklearn's
RandomForestRegressor, ``_fanova/_evaluator.py:132``; here the forest is
the histogram forest :mod:`optuna_tpu_torch.ops.forest` on ``device``), then for each
tree an exact functional-ANOVA first-order decomposition over the tree's
split boxes (``_tree.py``):
``importance_j = E_trees[ Var_{x_j}(marginal_j) / Var(tree) ]``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np

from optuna_tpu_torch.importance._base import BaseImportanceEvaluator
from optuna_tpu_torch.importance._evaluate import _get_filtered_trials, _target_values
from optuna_tpu_torch.transform import SearchSpaceTransform

if TYPE_CHECKING:
    import torch

    from optuna_tpu_torch.study.study import Study


def _tree_boxes(tree) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(leaf_lows (L,d), leaf_highs (L,d), leaf_values (L,)) of one fitted
    sklearn tree over the unit box."""
    t = tree.tree_
    d = tree.n_features_in_
    lows, highs, values = [], [], []

    def dfs(node: int, lo: np.ndarray, hi: np.ndarray) -> None:
        if t.children_left[node] == -1:  # leaf
            lows.append(lo.copy())
            highs.append(hi.copy())
            values.append(float(t.value[node].ravel()[0]))
            return
        f, thr = int(t.feature[node]), float(t.threshold[node])
        hi2 = hi.copy()
        hi2[f] = min(hi[f], thr)
        dfs(int(t.children_left[node]), lo, hi2)
        lo2 = lo.copy()
        lo2[f] = max(lo[f], thr)
        dfs(int(t.children_right[node]), lo2, hi)

    dfs(0, np.zeros(d), np.ones(d))
    return np.asarray(lows), np.asarray(highs), np.asarray(values)


def _tree_group_variances(
    tree, groups: list[np.ndarray]
) -> tuple[np.ndarray, float]:
    """First-order marginal variance per *feature group* + total variance,
    exact over the split-box partition (uniform measure on the unit box).

    A group is the set of encoded columns of one parameter — a single column
    for numericals, all one-hot columns for a categorical. Marginalizing the
    group *jointly* (not summing per-column variances) is what the reference
    fANOVA computes via ``column_to_encoded_columns``
    (``_fanova/_evaluator.py:121``, ``_fanova/_fanova.py``)."""
    lows, highs, values = _tree_boxes(tree)
    widths = highs - lows  # (L, d)
    vols = np.prod(widths, axis=1)  # (L,)
    mean = float(np.sum(values * vols))
    total_var = float(np.sum(values * values * vols) - mean * mean)
    if total_var <= 0:
        return np.zeros(len(groups)), 0.0

    group_var = np.zeros(len(groups))
    for gi, dims in enumerate(groups):
        seg_weights = []  # per dim: (S_j,)
        covers = []  # per dim: (S_j, L)
        for j in dims:
            cuts = np.unique(np.concatenate([lows[:, j], highs[:, j], [0.0, 1.0]]))
            seg_lo, seg_hi = cuts[:-1], cuts[1:]
            mids = 0.5 * (seg_lo + seg_hi)
            seg_weights.append(seg_hi - seg_lo)
            covers.append(
                (lows[:, j][None, :] <= mids[:, None])
                & (mids[:, None] < highs[:, j][None, :])
            )
        denom = np.prod(
            [np.where(widths[:, j] > 0, widths[:, j], 1.0) for j in dims], axis=0
        )
        # M[s1..sk] = sum_l (prod_j cover_j[s_j, l]) * value_l * vol_other_l:
        # one contraction over the shared leaf index. Integer-sublist einsum
        # form — letter subscripts would collide/overflow past 25 group dims
        # (e.g. a 26-choice categorical).
        k = len(dims)
        leaf_ax = k  # shared contracted axis id
        operands: list = []
        for ax, cov in enumerate(covers):
            operands.extend([cov.astype(np.float64), [ax, leaf_ax]])
        operands.extend([values * vols / denom, [leaf_ax]])
        m = np.einsum(*operands, list(range(k)))
        w = seg_weights[0]
        for sw in seg_weights[1:]:
            w = np.multiply.outer(w, sw)
        group_var[gi] = max(float(np.sum(w * (m - mean) ** 2)), 0.0)
    return group_var, total_var


class FanovaImportanceEvaluator(BaseImportanceEvaluator):
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
        from optuna_tpu_torch.ops.forest import fit_forest

        trials, params = _get_filtered_trials(study, params, target)
        space = {p: trials[0].distributions[p] for p in params}
        # Raw (non-log) numerical values, like the reference's fANOVA
        # (`_fanova/_evaluator.py:110`): the ANOVA measure is uniform over the
        # *raw* box. The affine 0-1 rescaling preserves both sklearn's split
        # structure and uniform-measure marginal variances, so the unit-box
        # math below matches the reference's raw-bounds computation exactly.
        trans = SearchSpaceTransform(
            space, transform_log=False, transform_step=False, transform_0_1=True
        )
        X = trans.encode_many([t.params for t in trials])
        y = _target_values(trials, target)

        if len(np.unique(y)) == 1:
            return {p: 0.0 for p in params}

        trees = fit_forest(
            X, y,
            n_trees=self._n_trees,
            max_depth=self._max_depth,
            min_samples_split=2,
            seed=self._seed,
            device=self._device,
        )

        groups = [np.asarray(cols) for cols in trans.column_to_encoded_columns]
        fractions = np.zeros(len(groups))
        n_used = 0
        for tree in trees:
            gv, tv = _tree_group_variances(tree, groups)
            if tv > 0:
                fractions += gv / tv
                n_used += 1
        if n_used:
            fractions /= n_used

        importances = {p: float(fractions[i]) for i, p in enumerate(params)}
        return dict(sorted(importances.items(), key=lambda kv: kv[1], reverse=True))
