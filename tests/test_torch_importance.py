"""The port's importance evaluators (``optuna_tpu_torch/importance/``)
against the reference's (``optuna_tpu/importance/``), on the CPU.

Both packages get the same trials (``FrozenTrial`` rows from a NumPy seed).
Tolerances:

* PED-ANOVA is host NumPy on both sides: bit for bit, including the
  quantile options, conditional parameters and a multi-objective study's
  split.
* fANOVA and MDI run each package's forest with the reference's bootstrap
  (``reference_forest_draws``). Spies record both forests; they must agree
  tree for tree up to proven near ties (``assert_forests_agree``, as in
  ``tests/test_torch_forest.py``). Where no tree parts, the importances are
  equal up to float32 (1e-6); where one does, a tie can credit another
  parameter with the same partition, so they are held within 0.02 (the
  reference's own band against sklearn, ``tests/test_importance_parity.py``)
  with the same top parameter.
* ``_tree_group_variances`` on the same trees: equal.
"""

from __future__ import annotations

import datetime
import warnings

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu.ops import forest as ref_forest
from optuna_tpu_torch.ops import forest as port_forest
from tests._torch_port import (  # noqa: F401
    assert_forests_agree,
    jax_bootstrap_weights,
    one_torch_thread,
    reference_forest_draws,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = "cpu"
_NOW = datetime.datetime(2026, 1, 1)


def _dists(mod):
    d = mod.distributions
    return {
        "x": d.FloatDistribution(-1.0, 1.0),
        "y": d.FloatDistribution(-1.0, 1.0),
        "z": d.FloatDistribution(-1.0, 1.0),
        "c": d.CategoricalDistribution(("a", "b", "c")),
        "k": d.IntDistribution(1, 64, log=True),
    }


def _build_study(mod, n=80, seed=0, directions=None):
    """The reference parity test's study (``tests/test_importance_parity.py``)
    in ``mod``; with two ``directions`` the second objective is ``z``-driven."""
    rng = np.random.RandomState(seed)
    xs, ys, zs = rng.uniform(-1, 1, (3, n))
    cats = rng.choice(["a", "b", "c"], n)
    ints = rng.randint(1, 65, n)
    vals = 3 * xs**2 + 0.5 * ys + (cats == "b") * 0.3 + np.log2(ints) * 0.05
    study = mod.create_study(directions=directions)
    for i in range(n):
        values = [float(vals[i]), float(zs[i] ** 2 - 0.2 * xs[i])] if directions else None
        study.add_trial(
            mod.trial.FrozenTrial(
                number=i, state=mod.trial.TrialState.COMPLETE,
                value=None if directions else float(vals[i]), values=values,
                datetime_start=_NOW, datetime_complete=_NOW,
                params={"x": float(xs[i]), "y": float(ys[i]), "z": float(zs[i]), "c": str(cats[i]),
                        "k": int(ints[i])},
                distributions=_dists(mod), user_attrs={}, system_attrs={}, intermediate_values={},
                trial_id=i,
            )
        )
    return study


def _conditional_study(mod):
    """The reference parity test's conditional space (condPED-ANOVA regimes)."""
    d = mod.distributions
    rng = np.random.RandomState(3)
    study = mod.create_study()
    for i in range(60):
        use_a = bool(rng.randint(0, 2))
        params = {"arm": "a" if use_a else "b"}
        dists = {"arm": d.CategoricalDistribution(("a", "b"))}
        if use_a:
            params["lr"] = float(rng.uniform(1e-4, 1e-1))
            dists["lr"] = d.FloatDistribution(1e-4, 1e-1, log=True)
            value = -np.log10(params["lr"])
        else:
            params["depth"] = int(rng.randint(1, 9))
            dists["depth"] = d.IntDistribution(1, 8)
            value = float(params["depth"])
        study.add_trial(
            mod.trial.FrozenTrial(
                number=i, state=mod.trial.TrialState.COMPLETE, value=value,
                datetime_start=_NOW, datetime_complete=_NOW, params=params, distributions=dists,
                user_attrs={}, system_attrs={}, intermediate_values={}, trial_id=i,
            )
        )
    return study


def _importances(mod, study, evaluator, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod.importance.get_param_importances(study, evaluator=evaluator, normalize=False, **kwargs)


# ------------------------------------------------------------------ PED-ANOVA


PED_CASES = {
    "seed0": ({}, 0),
    "seed7": ({}, 7),
    "quantiles": ({"target_quantile": 0.2, "region_quantile": 0.6}, 0),
    "global": ({"evaluate_on_local": False}, 1),
    "baseline_alias": ({"baseline_quantile": 0.3}, 2),
}


@pytest.mark.parametrize("case", sorted(PED_CASES))
def test_ped_anova_is_bit_exact(case):
    kwargs, seed = PED_CASES[case]
    ref = _importances(optuna_tpu, _build_study(optuna_tpu, seed=seed),
                       optuna_tpu.importance.PedAnovaImportanceEvaluator(**kwargs))
    port = _importances(optuna_tpu_torch, _build_study(optuna_tpu_torch, seed=seed),
                        optuna_tpu_torch.importance.PedAnovaImportanceEvaluator(**kwargs))
    assert list(port.items()) == list(ref.items())  # values and order


def test_ped_anova_conditional_params_are_bit_exact():
    ref = _importances(optuna_tpu, _conditional_study(optuna_tpu),
                       optuna_tpu.importance.PedAnovaImportanceEvaluator())
    port = _importances(optuna_tpu_torch, _conditional_study(optuna_tpu_torch),
                        optuna_tpu_torch.importance.PedAnovaImportanceEvaluator())
    assert list(port.items()) == list(ref.items())
    assert set(port) == {"arm", "lr", "depth"}


def test_ped_anova_multi_objective_split_and_target_are_bit_exact():
    directions = ["minimize", "maximize"]
    ref_study = _build_study(optuna_tpu, n=64, seed=4, directions=directions)
    port_study = _build_study(optuna_tpu_torch, n=64, seed=4, directions=directions)
    ref = _importances(optuna_tpu, ref_study, optuna_tpu.importance.PedAnovaImportanceEvaluator())
    port = _importances(optuna_tpu_torch, port_study,
                        optuna_tpu_torch.importance.PedAnovaImportanceEvaluator(device=CPU))
    assert list(port.items()) == list(ref.items())
    ref = _importances(optuna_tpu, ref_study, optuna_tpu.importance.PedAnovaImportanceEvaluator(),
                       target=lambda t: t.values[1])
    port = _importances(optuna_tpu_torch, port_study, optuna_tpu_torch.importance.PedAnovaImportanceEvaluator(),
                        target=lambda t: t.values[1])
    assert list(port.items()) == list(ref.items())


def test_ped_anova_edge_cases_match():
    for mod in (optuna_tpu, optuna_tpu_torch):
        with pytest.raises(ValueError, match="target_quantile"):
            mod.importance.PedAnovaImportanceEvaluator(target_quantile=0.5, region_quantile=0.5)
        study = _build_study(mod, n=1)
        assert _importances(mod, study, mod.importance.PedAnovaImportanceEvaluator()) == dict.fromkeys(
            sorted(_dists(mod)), 0.0)
        with pytest.raises(ValueError, match="No completed trial"):
            _importances(mod, _build_study(mod, n=8), mod.importance.PedAnovaImportanceEvaluator(), params=["nope"])


# ---------------------------------------------------------- fANOVA and MDI


@pytest.fixture
def forest_spies(monkeypatch):
    """Record every forest both packages grow: (X, y, seed, n_trees, trees)."""
    grown = {"ref": [], "port": []}

    def spy(side, real):
        def fit(X, y, **kwargs):
            trees = real(X, y, **kwargs)
            grown[side].append((np.array(X), np.array(y), kwargs.get("seed"), kwargs.get("n_trees", 64), trees))
            return trees

        return fit

    monkeypatch.setattr(ref_forest, "fit_forest", spy("ref", ref_forest.fit_forest))
    monkeypatch.setattr(port_forest, "fit_forest", spy("port", port_forest.fit_forest))
    return grown


def _hold_forests(grown) -> int:
    (X, y, seed, n_trees, ref_trees), = grown["ref"]
    (pX, py, _, _, port_trees), = grown["port"]
    np.testing.assert_array_equal(pX, X)
    np.testing.assert_array_equal(py, y)
    y_std = (y - y.mean()) / (y.std() or 1.0)
    return assert_forests_agree(
        ref_trees, port_trees, X, y_std, jax_bootstrap_weights(n_trees, len(X), seed), scale=float(y.std())
    )


def _hold_importances(ref, port, partings):
    assert list(port) == list(ref) or partings  # the same order where no tree parts
    if partings == 0:
        for k in ref:
            assert port[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-9), k
    else:
        for k in ref:
            assert port[k] == pytest.approx(ref[k], abs=0.02), k
        assert max(port, key=port.get) == max(ref, key=ref.get)


EVALUATORS = ["FanovaImportanceEvaluator", "MeanDecreaseImpurityImportanceEvaluator"]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", EVALUATORS)
def test_forest_importances_match_the_reference_with_its_bootstrap(name, seed, reference_forest_draws, forest_spies):
    ref = _importances(optuna_tpu, _build_study(optuna_tpu, seed=seed),
                       getattr(optuna_tpu.importance, name)(n_trees=16, seed=seed))
    port = _importances(optuna_tpu_torch, _build_study(optuna_tpu_torch, seed=seed),
                        getattr(optuna_tpu_torch.importance, name)(n_trees=16, seed=seed, device=CPU))
    _hold_importances(ref, port, _hold_forests(forest_spies))
    assert max(port, key=port.get) == "x"


@pytest.mark.parametrize("name", EVALUATORS)
def test_forest_importances_with_a_target_and_params(name, reference_forest_draws, forest_spies):
    target = lambda t: t.params["y"] * 2 + t.params["z"]  # noqa: E731
    ref = _importances(optuna_tpu, _build_study(optuna_tpu, seed=2),
                       getattr(optuna_tpu.importance, name)(n_trees=8, seed=1), target=target, params=["y", "z", "c"])
    port = _importances(optuna_tpu_torch, _build_study(optuna_tpu_torch, seed=2),
                        getattr(optuna_tpu_torch.importance, name)(n_trees=8, seed=1, device=CPU),
                        target=target, params=["y", "z", "c"])
    assert set(port) == {"y", "z", "c"}
    _hold_importances(ref, port, _hold_forests(forest_spies))


def test_fanova_constant_target_is_all_zero():
    for mod, kw in ((optuna_tpu, {}), (optuna_tpu_torch, {"device": CPU})):
        study = _build_study(mod, n=20)
        imp = _importances(mod, study, mod.importance.FanovaImportanceEvaluator(seed=0, **kw), target=lambda t: 1.0)
        assert imp == dict.fromkeys(["x", "y", "z", "c", "k"], 0.0)


def test_tree_group_variances_equal_the_reference_on_the_same_trees():
    from optuna_tpu.importance._fanova import _tree_group_variances as ref_tgv
    from optuna_tpu_torch.importance._fanova import _tree_group_variances as port_tgv

    rng = np.random.RandomState(0)
    X = rng.rand(90, 5)
    y = np.sin(3 * X[:, 0]) + X[:, 1] * X[:, 2]
    groups = [np.array([0]), np.array([1, 2]), np.array([3]), np.array([4])]
    for tree in port_forest.fit_forest(X, y, n_trees=4, seed=0, device=CPU):
        gv, tv = port_tgv(tree, groups)
        rgv, rtv = ref_tgv(tree, groups)
        np.testing.assert_array_equal(gv, rgv)
        assert tv == rtv


# ------------------------------------------------------ get_param_importances


def test_get_param_importances_normalizes_and_orders_as_the_reference():
    ref_study, port_study = _build_study(optuna_tpu, seed=5), _build_study(optuna_tpu_torch, seed=5)
    ref = optuna_tpu.importance.get_param_importances(
        ref_study, evaluator=optuna_tpu.importance.PedAnovaImportanceEvaluator())
    port = optuna_tpu_torch.importance.get_param_importances(
        port_study, evaluator=optuna_tpu_torch.importance.PedAnovaImportanceEvaluator())
    assert list(port.items()) == list(ref.items())
    assert sum(port.values()) == pytest.approx(1.0)
    raw = _importances(optuna_tpu_torch, port_study, optuna_tpu_torch.importance.PedAnovaImportanceEvaluator())
    total = sum(raw.values())
    assert port == {k: v / total for k, v in raw.items()}
    sub = optuna_tpu_torch.importance.get_param_importances(
        port_study, evaluator=optuna_tpu_torch.importance.PedAnovaImportanceEvaluator(), params=["x", "c"])
    assert set(sub) == {"x", "c"}


def test_get_param_importances_errors_match_the_reference():
    for mod, kw in ((optuna_tpu, {}), (optuna_tpu_torch, {"device": CPU})):
        mo = _build_study(mod, n=10, directions=["minimize", "minimize"])
        with pytest.raises(ValueError, match="specify the `target`"):
            mod.importance.get_param_importances(mo, evaluator=mod.importance.FanovaImportanceEvaluator(**kw))
        with pytest.raises(ValueError, match="does not contain completed trials"):
            mod.importance.get_param_importances(
                mod.create_study(), evaluator=mod.importance.FanovaImportanceEvaluator(**kw))


def test_the_forest_evaluators_run_on_the_card_by_default():
    study = _build_study(optuna_tpu_torch, n=30)
    if not torch.cuda.is_available():
        for name in EVALUATORS + [None]:
            evaluator = getattr(optuna_tpu_torch.importance, name)(seed=0) if name else None
            with pytest.raises(RuntimeError, match="no GPU"):
                optuna_tpu_torch.importance.get_param_importances(study, evaluator=evaluator)


def test_the_package_surface_matches_the_reference():
    assert optuna_tpu_torch.importance.__all__ == optuna_tpu.importance.__all__
    for name in optuna_tpu_torch.importance.__all__:
        assert getattr(optuna_tpu_torch.importance, name) is not None
    assert set(dir(optuna_tpu_torch.importance)) >= set(optuna_tpu_torch.importance.__all__)
    with pytest.raises(AttributeError):
        optuna_tpu_torch.importance.NoSuchEvaluator  # noqa: B018
