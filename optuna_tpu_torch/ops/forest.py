"""Histogram-split random-forest regressor in torch (port of
``optuna_tpu/ops/forest.py``).

Parity target: the sklearn ``RandomForestRegressor`` the reference leans on
for fANOVA/MDI importances (``optuna/importance/_fanova/_evaluator.py:132``,
``_mean_decrease_impurity.py:57``). Trees grow level-synchronously over a
dense heap layout, a chunk of trees at a time, and each level's split
search is one batch of tensor ops: one ``index_add_`` of the three
statistics (count, Σy, Σy²) over (tree, node, feature, bin), cumulative
sums along bins, and one argmax over the variance-reduction surface. That
is the XGBoost-style histogram formulation.

Differences by design (documented, covered by the tolerance parity test
``tests/test_importance_parity.py``):

* splits are searched over per-feature quantile bins (``n_bins``; exact for
  n <= n_bins distinct values) instead of every midpoint — the standard
  histogram-tree approximation;
* depth is capped (default 10 ≈ fully-grown for n ≤ ~1000 trials) because
  fixed-shape level growth allocates the heap frontier up front; sklearn's
  ``max_depth=64`` is effectively unbounded.

Where the port differs from the reference, on purpose:

* **The bootstrap is an argument.** :func:`_grow_trees` takes bootstrap
  weights (T, n); :func:`_bootstrap_weights` draws them from a CPU
  ``torch.Generator`` seeded with ``seed`` (0 for ``None``), so the card
  and the CPU see the same draws. ``jax.random.choice``'s stream cannot be
  reproduced; the parity tests hand in the reference's own draws instead.
* **Sums in another order on the card.** CUDA's float32 ``index_add_``
  adds with atomics, so Σy and Σy² come out in another order from run to
  run; counts are integer weights, exact in float32. A near tie between
  two splits can part from the CPU, which adds in sample order as the
  reference does.
* **One host read a chunk.** The five per-node arrays come back packed in
  one float32 tensor (features and bins are small integers, exact there).
* **No device policy.** The reference wraps the loop in
  ``_device_policy.small_kernel_scope()``; the port runs where ``device``
  says, the card unless the caller asks for the CPU.

Trees export sklearn-compatible structure arrays (``children_left``,
``feature``, ``threshold``, ``value``), so the exact fANOVA box
decomposition in :mod:`optuna_tpu_torch.importance._fanova` consumes either
implementation unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from optuna_tpu_torch.logging import get_logger

_logger = get_logger(__name__)

_EPS = 1e-12

# Fixed-shape level growth allocates the full heap frontier (2^depth nodes)
# up front, so depth is hard-capped; sklearn's default 64 means "unbounded".
_MAX_DEVICE_DEPTH = 10


@dataclass
class _TreeArrays:
    """sklearn ``tree_``-shaped view of one fitted device tree."""

    children_left: np.ndarray  # (N,) int; -1 at leaves
    children_right: np.ndarray  # (N,)
    feature: np.ndarray  # (N,) int; -2 at leaves (sklearn convention)
    threshold: np.ndarray  # (N,) float; -2.0 at leaves
    value: np.ndarray  # (N,) node mean (bootstrap-weighted)
    n_node_samples: np.ndarray  # (N,) bootstrap-weighted counts
    impurity: np.ndarray  # (N,) node variance


class DeviceTree:
    """Duck-types the slice of sklearn's fitted-tree API the importance
    evaluators consume (``tree_`` arrays + ``n_features_in_``)."""

    def __init__(self, arrays: _TreeArrays, n_features: int) -> None:
        self.tree_ = arrays
        self.n_features_in_ = n_features


def _make_bins(X: np.ndarray, n_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature quantile binning. Returns (bin index per sample (n, d),
    upper-edge threshold per (feature, bin) — the sklearn-style midpoint
    between the last value inside the bin and the first value beyond it)."""
    n, d = X.shape
    bins = np.zeros((n, d), dtype=np.int32)
    thresholds = np.full((d, n_bins), np.inf, dtype=np.float64)
    for f in range(d):
        uniq = np.unique(X[:, f])
        if len(uniq) > n_bins:
            qs = np.quantile(uniq, np.linspace(0, 1, n_bins + 1)[1:-1])
            cuts = np.unique(qs)
        else:
            cuts = 0.5 * (uniq[:-1] + uniq[1:])  # exact midpoints
        bins[:, f] = np.searchsorted(cuts, X[:, f], side="right")
        thresholds[f, : len(cuts)] = cuts
    return bins, thresholds


def _bootstrap_weights(n_trees: int, n: int, seed: int | None) -> torch.Tensor:
    """(n_trees, n) float32 bootstrap weights on the CPU: each tree draws n
    rows with replacement, a row's weight is how often it was drawn."""
    gen = torch.Generator().manual_seed(0 if seed is None else int(seed))
    idx = torch.randint(0, n, (n_trees, n), generator=gen)
    w = torch.zeros(n_trees, n, dtype=torch.float32)
    return w.scatter_add_(1, idx, torch.ones(n_trees, n, dtype=torch.float32))


def _histograms(node_loc, w, y, bins, n_nodes_level: int, n_bins: int) -> torch.Tensor:
    """(T, L, d, B, 3) weighted (count, Σy, Σy²) of every (tree, level node,
    feature, bin), in one ``index_add_`` over a flat index. Samples outside
    the level carry weight 0 (at node 0), as in the reference."""
    T, n = w.shape
    d = bins.shape[1]
    tree = torch.arange(T, device=w.device)[:, None, None]
    f_idx = torch.arange(d, device=w.device)[None, None, :]
    cell = ((tree * n_nodes_level + node_loc[:, :, None]) * d + f_idx) * n_bins + bins[None, :, :]
    stat_idx = (cell[..., None] * 3 + torch.arange(3, device=w.device)).reshape(-1)
    wy = w * y
    src = torch.stack([w, wy, wy * y], dim=-1)[:, :, None, :].expand(T, n, d, 3).reshape(-1)
    out = torch.zeros(T * n_nodes_level * d * n_bins * 3, dtype=torch.float32, device=w.device)
    out.index_add_(0, stat_idx, src)
    return out.view(T, n_nodes_level, d, n_bins, 3)


def _grow_trees(
    weights: torch.Tensor,  # (T, n) float32 bootstrap weights
    bins: torch.Tensor,  # (n, d) int64
    y: torch.Tensor,  # (n,) float32
    max_depth: int,
    n_bins: int,
    min_samples_split: int,
) -> tuple[torch.Tensor, ...]:
    """Grow T trees level by level on ``weights``' device: (feature,
    split_bin, value, count, impurity), each (T, n_nodes)."""
    T, n = weights.shape
    d = bins.shape[1]
    dev = weights.device
    n_nodes = 2 ** (max_depth + 1) - 1
    node = torch.zeros(T, n, dtype=torch.int64, device=dev)
    feature = torch.full((T, n_nodes), -2, dtype=torch.int64, device=dev)
    split_bin = torch.full((T, n_nodes), -1, dtype=torch.int64, device=dev)
    stats = torch.zeros(T, n_nodes, 3, dtype=torch.float32, device=dev)  # count, Σy, Σy² per node
    bins_t = bins[None].expand(T, n, d)

    for level in range(max_depth + 1):
        L = 1 << level
        base = L - 1
        active = (node >= base) & (node < base + L)
        loc = torch.where(active, node - base, torch.zeros_like(node))
        wa = torch.where(active, weights, torch.zeros_like(weights))
        if level == max_depth:
            # The deepest level only records node stats: feature 0's bins
            # alone, summed as the reference sums them.
            hist = _histograms(loc, wa, y, bins[:, :1], L, n_bins)
            stats[:, base : base + L] = hist[:, :, 0].sum(dim=2)
            break
        hist = _histograms(loc, wa, y, bins, L, n_bins)  # (T, L, d, B, 3)
        node_stats = hist[:, :, 0].sum(dim=2)  # any feature's bins sum to the node
        stats[:, base : base + L] = node_stats
        node_cnt, node_sum = node_stats[..., 0], node_stats[..., 1]

        # Candidate split "bins <= b go left", proxy objective
        # Σ_l²/n_l + Σ_r²/n_r (maximizing ⇔ max variance reduction).
        cl = torch.cumsum(hist[..., 0], dim=-1)
        sl = torch.cumsum(hist[..., 1], dim=-1)
        cr = node_cnt[:, :, None, None] - cl
        sr = node_sum[:, :, None, None] - sl
        valid = (cl > 0) & (cr > 0)
        gain = torch.where(
            valid,
            sl * sl / torch.clamp(cl, min=_EPS) + sr * sr / torch.clamp(cr, min=_EPS),
            torch.full_like(cl, -torch.inf),
        )
        flat = gain.reshape(T, L, d * n_bins)
        best = torch.argmax(flat, dim=-1)  # the first maximum: ties break at the lowest (feature, bin)
        best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
        parent_score = node_sum * node_sum / torch.clamp(node_cnt, min=_EPS)
        can_split = (
            (node_cnt >= min_samples_split)
            & torch.isfinite(best_gain)
            & (best_gain > parent_score + 1e-7)
        )
        feature[:, base : base + L] = torch.where(can_split, best // n_bins, torch.full_like(best, -2))
        split_bin[:, base : base + L] = torch.where(can_split, best % n_bins, torch.full_like(best, -1))
        # Route samples: heap children are 2i+1 / 2i+2.
        f_of = torch.gather(feature, 1, node)
        my_bin = torch.gather(bins_t, 2, torch.clamp(f_of, min=0)[..., None])[..., 0]
        goes_right = (my_bin > torch.gather(split_bin, 1, node)).to(torch.int64)
        split_here = active & (f_of >= 0)
        node = torch.where(split_here, 2 * node + 1 + goes_right, node)

    cnt, s, ss = stats.unbind(-1)
    value = s / torch.clamp(cnt, min=_EPS)
    impurity = torch.clamp(ss / torch.clamp(cnt, min=_EPS) - value * value, min=0.0)
    return feature, split_bin, value, cnt, impurity


def fit_forest(
    X: np.ndarray,
    y: np.ndarray,
    *,
    n_trees: int = 64,
    max_depth: int = 64,
    n_bins: int = 128,
    min_samples_split: int = 2,
    seed: int | None = None,
    chunk: int = 8,
    device: "str | torch.device | None" = None,
) -> list[DeviceTree]:
    """Fit the forest on ``device`` (``None``: the card); returns
    sklearn-shaped fitted trees."""
    from optuna_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    n, d = X.shape
    # Fixed-shape level growth: depth beyond log2(n) only chases singleton
    # leaves, so the data-driven cap is lossless; the hard _MAX_DEVICE_DEPTH
    # cap is not, and a caller asking for more (e.g.
    # FanovaImportanceEvaluator(max_depth=64) expecting sklearn's effectively
    # unbounded trees) must hear about it rather than silently get shallower
    # trees once n outgrows 2**_MAX_DEVICE_DEPTH samples.
    data_cap = max(2, int(np.ceil(np.log2(max(n, 4)))) + 2)
    depth = int(min(max_depth, _MAX_DEVICE_DEPTH, data_cap))
    if min(max_depth, data_cap) > _MAX_DEVICE_DEPTH:
        _logger.warning(
            f"fit_forest: requested max_depth={max_depth} clamped to the device "
            f"cap of {_MAX_DEVICE_DEPTH} (n={n} samples could use depth "
            f"{min(max_depth, data_cap)}); importances may differ slightly from "
            "an unbounded-depth reference forest."
        )
    n_bins = int(min(n_bins, max(4, n + 1)))
    bins_np, thresholds = _make_bins(np.asarray(X, np.float64), n_bins)
    # Standardized targets keep the f32 split scores (Σy)²/n well away from
    # cancellation; exports are rescaled back below.
    y64 = np.asarray(y, np.float64)
    y_mean, y_std = float(y64.mean()), float(y64.std()) or 1.0
    y32 = torch.as_tensor(((y64 - y_mean) / y_std).astype(np.float32)).to(dev)
    bins_dev = torch.as_tensor(bins_np, dtype=torch.int64).to(dev)
    weights = _bootstrap_weights(n_trees, n, seed).to(dev)

    trees: list[DeviceTree] = []
    with torch.no_grad():
        for start in range(0, n_trees, chunk):
            grown = _grow_trees(
                weights[start : start + chunk], bins_dev, y32, max_depth=depth, n_bins=n_bins,
                min_samples_split=min_samples_split,
            )
            feat, sbin, value, cnt, imp = torch.stack([g.to(torch.float32) for g in grown]).cpu().numpy()
            for t in range(len(feat)):
                trees.append(
                    _export_tree(
                        feat[t].astype(np.int64), sbin[t].astype(np.int64),
                        value[t] * y_std + y_mean, cnt[t], imp[t] * y_std * y_std, thresholds, d,
                    )
                )
    return trees


def _export_tree(
    feature: np.ndarray,
    split_bin: np.ndarray,
    value: np.ndarray,
    cnt: np.ndarray,
    impurity: np.ndarray,
    thresholds: np.ndarray,
    d: int,
) -> DeviceTree:
    n_nodes = len(feature)
    internal = feature >= 0
    # A heap child only exists when its parent split: unreachable slots keep
    # children -1 so sklearn-style DFS from the root never visits them.
    idx = np.arange(n_nodes)
    children_left = np.where(internal, 2 * idx + 1, -1).astype(np.int64)
    children_right = np.where(internal, 2 * idx + 2, -1).astype(np.int64)
    children_left[children_left >= n_nodes] = -1
    children_right[children_right >= n_nodes] = -1
    thr = np.full(n_nodes, -2.0)
    thr[internal] = thresholds[feature[internal], split_bin[internal]]
    arrays = _TreeArrays(
        children_left=children_left,
        children_right=children_right,
        feature=np.where(internal, feature, -2).astype(np.int64),
        threshold=thr,
        value=np.asarray(value, np.float64),
        n_node_samples=np.asarray(cnt, np.float64),
        impurity=np.asarray(impurity, np.float64),
    )
    return DeviceTree(arrays, d)


def forest_feature_importances(trees: list[DeviceTree], d: int) -> np.ndarray:
    """Mean-decrease-impurity importances, sklearn semantics: per-tree
    weighted impurity decreases per feature, normalized per tree, averaged
    (``sklearn.tree._tree.Tree.compute_feature_importances``)."""
    total = np.zeros(d)
    used = 0
    for tree in trees:
        t = tree.tree_
        internal = t.children_left >= 0
        if not internal.any():
            continue
        nodes = np.flatnonzero(internal)
        left, right = t.children_left[nodes], t.children_right[nodes]
        dec = (
            t.n_node_samples[nodes] * t.impurity[nodes]
            - t.n_node_samples[left] * t.impurity[left]
            - t.n_node_samples[right] * t.impurity[right]
        )
        per_feat = np.zeros(d)
        np.add.at(per_feat, t.feature[nodes], np.maximum(dec, 0.0))
        s = per_feat.sum()
        if s > 0:
            total += per_feat / s
            used += 1
    return total / used if used else total
