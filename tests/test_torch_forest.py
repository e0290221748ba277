"""The port's histogram forest (``optuna_tpu_torch/ops/forest.py``) against
the reference's (``optuna_tpu/ops/forest.py``), on the CPU.

The bootstrap is the reference's own draws, handed to the port
(``tests/_torch_port.py::jax_bootstrap_weights``). Tolerances:

* ``_make_bins``, ``_export_tree`` and ``forest_feature_importances`` are
  host NumPy on both sides: equal.
* ``_grow_trees`` tree for tree: the same feature and split bin at every
  node, node value, count and impurity within 1e-5. The port's CPU scatter
  adds in sample order, but the reference's ``cumsum`` over bins sums in
  another order, so two splits whose gains tie in exact arithmetic can
  come out a float32 ulp apart on either side; where a split parts, the
  test shows the two gains over the node's samples (float64) within 1e-6
  relative: a near tie, not a fault (``assert_forests_agree``).
* Tests marked ``cuda`` hold the card's forest to the CPU's: the card adds
  with atomics in any order, so trees part at near ties there too.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optuna_tpu.ops import forest as ref_forest
from optuna_tpu_torch.ops import forest
from tests._torch_port import (  # noqa: F401
    assert_forests_agree,
    cuda_device,
    jax_bootstrap_weights,
    one_torch_thread,
    reference_forest_draws,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = "cpu"


def _data(n, d, seed, discrete=False):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 6, size=(n, d)) / 5.0 if discrete else rng.rand(n, d)
    y = 3 * X[:, 0] ** 2 + 0.5 * X[:, 1] + 0.05 * rng.randn(n)
    return X, y


def _assert_mostly_equal(trees, partings):
    """Not a vacuous comparison: the partings, each a proven near tie, are at
    most a tenth of the reference's splits."""
    internal = sum(int((t.tree_.feature >= 0).sum()) for t in trees)
    assert partings <= internal // 10, (partings, internal)


def _standardized(y):
    y64 = np.asarray(y, np.float64)
    return (y64 - y64.mean()) / (y64.std() or 1.0)


# (n, d, depth, n_bins, min_samples_split, discrete, seed): continuous and
# tied (six-valued) features, quantile bins (n > n_bins), a larger split floor.
GROW_CASES = {
    "continuous": (120, 5, 8, 64, 2, False, 0),
    "discrete": (90, 4, 7, 16, 2, True, 1),
    "quantile_bins": (200, 3, 8, 32, 2, False, 2),
    "min_split_5": (100, 4, 6, 64, 5, False, 3),
}


@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_grow_trees_matches_the_reference_tree_for_tree(case):
    n, d, depth, n_bins, min_split, discrete, seed = GROW_CASES[case]
    X, y = _data(n, d, seed, discrete)
    bins, thresholds = ref_forest._make_bins(X, n_bins)
    y32 = _standardized(y).astype(np.float32)
    n_trees = 6
    keys = jax.random.split(jax.random.PRNGKey(seed), n_trees)
    ref = jax.device_get(
        ref_forest._grow_trees(
            keys, jnp.asarray(bins), jnp.asarray(y32), max_depth=depth, n_bins=n_bins,
            min_samples_split=min_split,
        )
    )
    weights = jax_bootstrap_weights(n_trees, n, seed)
    port = forest._grow_trees(
        weights, torch.as_tensor(bins, dtype=torch.int64), torch.as_tensor(y32), depth, n_bins, min_split
    )
    port = [a.numpy() for a in port]
    assert [a.shape for a in port] == [a.shape for a in ref]

    def export(out):
        feat, sbin, value, cnt, imp = out
        return [
            forest._export_tree(feat[t].astype(np.int64), sbin[t].astype(np.int64), value[t], cnt[t], imp[t],
                                thresholds, d)
            for t in range(n_trees)
        ]

    partings = assert_forests_agree(export(ref), export(port), X, y32, weights)
    _assert_mostly_equal(export(ref), partings)


def test_make_bins_and_export_tree_equal_the_reference():
    X, y = _data(150, 4, 5)
    X[:, 3] = np.round(X[:, 3] * 4)  # few distinct values: exact midpoints
    for n_bins in (8, 128):
        bins, thr = forest._make_bins(X, n_bins)
        ref_bins, ref_thr = ref_forest._make_bins(X, n_bins)
        np.testing.assert_array_equal(bins, ref_bins)
        np.testing.assert_array_equal(thr, ref_thr)
    rng = np.random.RandomState(0)
    n_nodes = 15
    feature = np.where(rng.rand(n_nodes) < 0.5, rng.randint(0, 4, n_nodes), -2)
    feature[7:] = -2
    sbin = np.where(feature >= 0, rng.randint(0, 8, n_nodes), -1)
    value, cnt, imp = rng.rand(3, n_nodes)
    thr = forest._make_bins(X, 8)[1]
    port = forest._export_tree(feature, sbin, value, cnt, imp, thr, 4).tree_
    ref = ref_forest._export_tree(feature, sbin, value, cnt, imp, thr, 4).tree_
    for field in ("children_left", "children_right", "feature", "threshold", "value", "n_node_samples", "impurity"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field), err_msg=field)


def test_fit_forest_matches_the_reference_with_its_bootstrap(reference_forest_draws):
    X, y = _data(160, 5, 7)
    y = 10.0 + 4.0 * y  # a target off zero and off unit scale: the export's rescale
    ref_trees = ref_forest.fit_forest(X, y, n_trees=16, seed=3)
    port_trees = forest.fit_forest(X, y, n_trees=16, seed=3, device=CPU)
    partings = assert_forests_agree(
        ref_trees, port_trees, X, _standardized(y), jax_bootstrap_weights(16, len(X), 3), scale=float(np.std(y))
    )
    _assert_mostly_equal(ref_trees, partings)
    if partings == 0:
        np.testing.assert_allclose(
            forest.forest_feature_importances(port_trees, 5), ref_forest.forest_feature_importances(ref_trees, 5),
            rtol=0, atol=1e-6,
        )


def test_forest_feature_importances_equal_the_reference_on_the_same_trees():
    X, y = _data(120, 6, 8)
    trees = forest.fit_forest(X, y, n_trees=8, seed=0, device=CPU)
    imp = forest.forest_feature_importances(trees, 6)
    np.testing.assert_array_equal(imp, ref_forest.forest_feature_importances(trees, 6))
    assert imp.sum() == pytest.approx(1.0, abs=1e-12)
    assert imp[0] > imp[1] > max(imp[2:])
    leaf = forest.fit_forest(X, np.full(120, 2.5), n_trees=2, seed=0, device=CPU)
    np.testing.assert_array_equal(forest.forest_feature_importances(leaf, 6), np.zeros(6))


def test_depth_clamp_warns_only_when_lossy(caplog):
    """As the reference's test: a caller's max_depth above the device cap is
    announced, the data-driven cap is silent."""
    import optuna_tpu_torch

    X, y = _data(300, 4, 0)  # n=300: the data cap ~11 exceeds the device cap of 10
    optuna_tpu_torch.logging.enable_propagation()
    try:
        with caplog.at_level(logging.WARNING, logger="optuna_tpu_torch.ops.forest"):
            forest.fit_forest(X, y, n_trees=2, max_depth=64, seed=0, device=CPU)
        assert any("clamped" in r.message for r in caplog.records)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="optuna_tpu_torch.ops.forest"):
            forest.fit_forest(X, y, n_trees=2, max_depth=8, seed=0, device=CPU)
            forest.fit_forest(X[:32], y[:32], n_trees=2, max_depth=64, seed=0, device=CPU)
        assert not any("clamped" in r.message for r in caplog.records)
    finally:
        optuna_tpu_torch.logging.disable_propagation()


def test_bootstrap_weights_are_seeded_draws_with_replacement():
    w = forest._bootstrap_weights(5, 40, 3)
    assert w.shape == (5, 40) and w.dtype == torch.float32 and w.device.type == "cpu"
    assert torch.all(w.sum(dim=1) == 40) and torch.all(w == w.round()) and torch.all(w >= 0)
    assert torch.equal(w, forest._bootstrap_weights(5, 40, 3))
    assert torch.equal(forest._bootstrap_weights(5, 40, None), forest._bootstrap_weights(5, 40, 0))
    assert not torch.equal(w[0], w[1])  # each tree its own draw
    assert not torch.equal(w, forest._bootstrap_weights(5, 40, 4))


def test_structure_invariants_and_one_read_a_chunk(monkeypatch):
    """The reference's structure test, and the host reads: ``fit_forest``
    copies each chunk's trees back in one read (chunk 8: 2 reads for 16)."""
    X, y = _data(200, 5, 1)
    reads = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *args, **kwargs):
        reads.append(tuple(self.shape))
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    trees = forest.fit_forest(X, y, n_trees=16, seed=1, device=CPU)
    monkeypatch.undo()
    assert len(reads) == 2 and all(r[:2] == (5, 8) for r in reads)
    for tree in trees:
        t = tree.tree_
        internal = t.children_left >= 0
        assert internal.any()
        assert (t.children_left[internal] < len(t.children_left)).all()
        assert (t.feature[internal] >= 0).all() and (t.feature[~internal] == -2).all()
        assert np.isfinite(t.threshold[internal]).all()
        assert t.n_node_samples[0] == pytest.approx(len(X))


def test_the_card_is_the_default_and_raises_without_one():
    X, y = _data(40, 3, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            forest.fit_forest(X, y, n_trees=2, seed=0)


@pytest.mark.cuda
def test_card_forest_agrees_with_the_cpu(cuda_device):  # noqa: F811
    """The card's forest against the CPU's on the same bootstrap, at the
    importance phase's size (1100 trials, 20 dims): trees equal up to near
    ties (atomics add in another order: gains within 1e-5, node stats within
    1e-4), MDI importances within 0.02 with the same top feature."""
    X, y = _data(1100, 20, 4)
    cpu = forest.fit_forest(X, y, n_trees=16, seed=0, device=CPU)
    card = forest.fit_forest(X, y, n_trees=16, seed=0, device=cuda_device)
    partings = assert_forests_agree(
        cpu, card, X, _standardized(y), forest._bootstrap_weights(16, len(X), 0), scale=float(np.std(y)),
        atol=1e-4, gain_rtol=1e-5,  # sums in any order: float32 gains a few ulps of n apart
    )
    imp_cpu = forest.forest_feature_importances(cpu, 20)
    imp_card = forest.forest_feature_importances(card, 20)
    np.testing.assert_allclose(imp_card, imp_cpu, rtol=0, atol=0.02)
    assert int(np.argmax(imp_card)) == int(np.argmax(imp_cpu)) == 0
    assert partings <= 16 * 20
