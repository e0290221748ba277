"""The port's visualization (``optuna_tpu_torch/visualization/``) against the
reference's (``optuna_tpu/visualization/``), on the CPU.

Both packages get identical trials: ``FrozenTrial`` rows built from one
NumPy seed with fixed ``datetime_start``/``datetime_complete`` (the
timeline and EDF read them), COMPLETE, PRUNED (with intermediate values)
and FAIL trials, constraint attrs on the multi-objective rows. No RUNNING
trial is built: the timeline draws one up to the wall clock's ``now``,
which no two calls share. plotly is not installed, so every ``plot_*``
returns the figure dict in plotly's schema, and the dicts must be equal
(NaN equal to NaN), with these exceptions, each named where it is tested:

* ``plot_param_importances`` compares the PED-ANOVA evaluator (host NumPy,
  bit for bit); the default fANOVA takes ``device="cpu"`` and is checked
  for shape, since its bootstrap stream is each package's own
  (``tests/test_torch_importance.py`` holds the forests);
* ``plot_hypervolume_history`` at five objectives routes each prefix of 32
  or more front points to the WFG stack (the port's plain stack loop on the
  CPU, the reference's XLA loop): values within 1e-6 relative, the WFG
  parity bar of ``tests/test_torch_wfg.py``;
* ``plot_terminator_improvement`` with the default GP evaluator: each
  package fits its own GP, so the improvement series is held within
  1e-2 of the objective's standard deviation (the GP host atol of 1e-3 on
  the posterior, through max(μ ± √β σ), √β ≈ 4), the error series equal.

The matplotlib mirror renders every plot under Agg, and its artists (line
vertices, scatter offsets, bar geometry, texts, labels, scales) equal the
reference mirror's. matplotlib is imported by those tests alone (the
``pyplot`` fixture): the card host, which runs this file's collection for
the ``cuda`` tests, has none.
"""

from __future__ import annotations

import datetime
import json
import math

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from tests._torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = "cpu"
_T0 = datetime.datetime(2026, 1, 1, 12, 0, 0)
PACKAGES = (optuna_tpu, optuna_tpu_torch)


def _frozen(mod, i, state, params, dists, value=None, values=None, intermediate=None, system_attrs=None):
    start = _T0 + datetime.timedelta(seconds=7 * i)
    return mod.trial.FrozenTrial(
        number=i, state=state, value=value, values=values,
        datetime_start=start, datetime_complete=start + datetime.timedelta(seconds=1 + i % 5, milliseconds=250),
        params=params, distributions=dists, user_attrs={}, system_attrs=system_attrs or {},
        intermediate_values=intermediate or {}, trial_id=i,
    )


def _single(mod, n=30, seed=0, direction="minimize", noise=0.0):
    """x (float), lr (log float), c (categorical), k (int, step 2); every
    seventh trial PRUNED at step 1, every eleventh FAIL."""
    d = mod.distributions
    dists = {
        "x": d.FloatDistribution(-3.0, 3.0),
        "lr": d.FloatDistribution(1e-5, 1e-1, log=True),
        "c": d.CategoricalDistribution(("adam", "sgd")),
        "k": d.IntDistribution(1, 9, step=2),
    }
    rng = np.random.RandomState(seed)
    study = mod.create_study(study_name=f"viz-{seed}", direction=direction)
    for i in range(n):
        x, lr = float(rng.uniform(-3, 3)), float(np.exp(rng.uniform(np.log(1e-5), np.log(1e-1))))
        c, k = str(rng.choice(["adam", "sgd"])), int(rng.choice([1, 3, 5, 7, 9]))
        value = x * x + (0.5 if c == "sgd" else 0.0) + math.log10(lr) * 0.01 + 0.1 * k + noise * rng.normal()
        steps = {s: x * x + s for s in range(3)}
        params = {"x": x, "lr": lr, "c": c, "k": k}
        if i % 11 == 10:
            study.add_trial(_frozen(mod, i, mod.trial.TrialState.FAIL, params, dists))
        elif i % 7 == 6:
            study.add_trial(_frozen(mod, i, mod.trial.TrialState.PRUNED, params, dists,
                                    intermediate={0: steps[0], 1: steps[1]}))
        else:
            study.add_trial(_frozen(mod, i, mod.trial.TrialState.COMPLETE, params, dists, value=value,
                                    intermediate=steps))
    return study


def _multi(mod, n=25, seed=1, m=2, constraints=True):
    """``m`` objectives over a, b: (a, (1-a)(1+b), ...) so the front has
    dominated points; a constraint attr ``a - 0.6 <= 0`` on each row."""
    d = mod.distributions
    dists = {"a": d.FloatDistribution(0, 1), "b": d.FloatDistribution(0, 1)}
    rng = np.random.RandomState(seed)
    study = mod.create_study(directions=["minimize"] * (m - 1) + ["maximize"])
    for i in range(n):
        a, b = rng.uniform(0, 1, 2)
        if m == 2:
            values = [float(a), float(-(1 - a) * (1 + b))]
        else:  # DTLZ2-like on a sphere of radius 1 + 0.2 b (1 at m >= 5: all non-dominated)
            theta = rng.uniform(0, np.pi / 2, m - 1)
            f = np.ones(m) * (1 + (0.2 * b if m < 5 else 0.0))
            for j in range(m - 1):
                f[: m - 1 - j] *= np.cos(theta[j])
                f[m - 1 - j] *= np.sin(theta[j])
            values = [float(v) for v in f[:-1]] + [float(-f[-1])]
        attrs = {"constraints": (float(a) - 0.6,)} if constraints else {}
        study.add_trial(_frozen(mod, i, mod.trial.TrialState.COMPLETE, {"a": float(a), "b": float(b)}, dists,
                                values=values, system_attrs=attrs))
    return study


def _norm(obj):
    """JSON-able plain data, NaN as a marker so that NaN equals NaN."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, np.ndarray)):
        return [_norm(v) for v in obj]
    if isinstance(obj, (np.floating, float)):
        return "nan" if math.isnan(obj) else float(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    return obj


def _both(fn, *studies_of, port_kwargs=None, **kwargs):
    """``fn``'s figure from each package on its own copy of the studies."""
    ref = getattr(optuna_tpu.visualization, fn)(*[s(optuna_tpu) for s in studies_of], **kwargs)
    port = getattr(optuna_tpu_torch.visualization, fn)(
        *[s(optuna_tpu_torch) for s in studies_of], **kwargs, **(port_kwargs or {})
    )
    assert isinstance(ref, dict) and isinstance(port, dict)  # plotly is absent: the schema dicts
    json.dumps(port)
    return _norm(ref), _norm(port)


def single(mod):
    return _single(mod)


def multi(mod):
    return _multi(mod)


def multi3(mod):
    return _multi(mod, n=30, seed=2, m=3)


EQUAL_CASES = {
    "optimization_history": ("plot_optimization_history", (single,), {}),
    "optimization_history_target": ("plot_optimization_history", (single,),
                                    {"target": lambda t: t.params["x"], "target_name": "x"}),
    "intermediate_values": ("plot_intermediate_values", (single,), {}),
    "edf": ("plot_edf", (single,), {}),
    "slice": ("plot_slice", (single,), {}),
    "slice_params": ("plot_slice", (single,), {"params": ["lr", "c"]}),
    "contour_pair": ("plot_contour", (single,), {"params": ["x", "lr"]}),
    "contour_matrix": ("plot_contour", (single,), {"params": ["x", "lr", "c"]}),
    "rank": ("plot_rank", (single,), {}),
    "parallel_coordinate": ("plot_parallel_coordinate", (single,), {}),
    "timeline": ("plot_timeline", (single,), {}),
    "pareto_front": ("plot_pareto_front", (multi,), {}),
    "pareto_front_feasible_only": ("plot_pareto_front", (multi,), {"include_dominated_trials": False}),
    "pareto_front_axis_order": ("plot_pareto_front", (multi,), {"axis_order": [1, 0]}),
    "pareto_front_constraints_func": ("plot_pareto_front", (multi,),
                                      {"constraints_func": lambda t: (t.params["b"] - 0.5,)}),
    "pareto_front_3d": ("plot_pareto_front", (multi3,), {"target_names": ["f0", "f1", "f2"]}),
    "hypervolume_history_2d": ("plot_hypervolume_history", (multi,), {"reference_point": [1.5, 0.5]}),
}


@pytest.mark.parametrize("case", sorted(EQUAL_CASES))
def test_figure_equals_the_reference(case):
    fn, studies, kwargs = EQUAL_CASES[case]
    ref, port = _both(fn, *studies, **kwargs)
    assert port == ref


def test_multi_study_history_and_edf_equal_the_reference():
    for fn, kwargs in (("plot_optimization_history", {}), ("plot_optimization_history", {"error_bar": True}),
                       ("plot_edf", {})):
        ref = getattr(optuna_tpu.visualization, fn)([_single(optuna_tpu, seed=s) for s in (0, 1, 2)], **kwargs)
        port = getattr(optuna_tpu_torch.visualization, fn)([_single(optuna_tpu_torch, seed=s) for s in (0, 1, 2)],
                                                           **kwargs)
        assert _norm(port) == _norm(ref), (fn, kwargs)


def test_metric_names_and_maximize_equal_the_reference():
    figs = []
    for mod in PACKAGES:
        study = _single(mod, seed=3, direction="maximize")
        study.set_metric_names(["accuracy"])
        figs.append([_norm(f) for f in (
            mod.visualization.plot_optimization_history(study),
            mod.visualization.plot_contour(study, params=["x", "k"]),
            mod.visualization.plot_rank(study, params=["x", "lr"]),
        )])
    assert figs[1] == figs[0]


def test_param_importances_equal_the_reference_with_ped_anova():
    for build in (single, multi):  # one bar group; one an objective
        figs = [
            _norm(mod.visualization.plot_param_importances(
                build(mod), evaluator=mod.importance.PedAnovaImportanceEvaluator(device=CPU)
                if mod is optuna_tpu_torch else mod.importance.PedAnovaImportanceEvaluator()))
            for mod in PACKAGES
        ]
        assert figs[1] == figs[0]


def test_param_importances_default_runs_on_the_given_device():
    study = _single(optuna_tpu_torch)
    fig = optuna_tpu_torch.visualization.plot_param_importances(study, device=CPU)
    (bar,) = fig["data"]
    assert sorted(bar["y"]) == ["c", "k", "lr", "x"] and sum(bar["x"]) == pytest.approx(1.0)
    assert bar["y"][-1] == "x"  # the most important last (top of a horizontal bar chart)
    ref = optuna_tpu.visualization.plot_param_importances(_single(optuna_tpu))
    assert fig["layout"] == ref["layout"] and ref["data"][0]["y"][-1] == "x"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            optuna_tpu_torch.visualization.plot_param_importances(study)


def test_hypervolume_history_at_five_objectives_routes_to_the_stack():
    """Prefixes from 32 front points on (the last three of 34 points on a
    sphere, all non-dominated) take the WFG stack (the plain stack loop on
    the CPU): within 1e-6 relative of the reference's XLA loop; the smaller
    prefixes are host float64 on both sides, equal."""
    ref_study, port_study = _multi(optuna_tpu, n=34, seed=5, m=5, constraints=False), _multi(
        optuna_tpu_torch, n=34, seed=5, m=5, constraints=False)
    reference_point = [1.5, 1.5, 1.5, 1.5, -1.5]  # the last objective is maximized
    ref = optuna_tpu.visualization.plot_hypervolume_history(ref_study, reference_point)
    port = optuna_tpu_torch.visualization.plot_hypervolume_history(port_study, reference_point, device=CPU)
    ref_hv, port_hv = ref["data"][0].pop("y"), port["data"][0].pop("y")
    assert _norm(port) == _norm(ref)
    np.testing.assert_array_equal(port_hv[:31], ref_hv[:31])
    np.testing.assert_allclose(port_hv, ref_hv, rtol=1e-6, atol=0)
    assert port_hv[0] > 0 and all(b >= a * (1 - 1e-6) for a, b in zip(port_hv, port_hv[1:]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            optuna_tpu_torch.visualization.plot_hypervolume_history(port_study, reference_point)


def test_terminator_improvement_with_host_evaluators_equals_the_reference():
    figs = []
    for mod in PACKAGES:
        t = mod.terminator
        figs.append(_norm(mod.visualization.plot_terminator_improvement(
            _single(mod), improvement_evaluator=t.BestValueStagnationEvaluator(5),
            error_evaluator=t.StaticErrorEvaluator(0.5), min_n_trials=10)))
    assert figs[1] == figs[0]


def test_terminator_improvement_with_the_default_gp_evaluator():
    ref = optuna_tpu.visualization.plot_terminator_improvement(_single(optuna_tpu, noise=0.3), min_n_trials=18)
    port_study = _single(optuna_tpu_torch, noise=0.3)
    port = optuna_tpu_torch.visualization.plot_terminator_improvement(port_study, min_n_trials=18, device=CPU)
    ref_imp, port_imp = ref["data"][0].pop("y"), port["data"][0].pop("y")
    assert _norm(port) == _norm(ref)  # trial numbers and the (host) error series
    sd = float(np.std([t.value for t in port_study.trials if t.value is not None]))
    np.testing.assert_allclose(port_imp, ref_imp, rtol=0, atol=1e-2 * sd)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            optuna_tpu_torch.visualization.plot_terminator_improvement(port_study, min_n_trials=18)


def test_surface_and_availability_match_the_reference():
    assert optuna_tpu_torch.visualization.__all__ == optuna_tpu.visualization.__all__
    assert optuna_tpu_torch.visualization.matplotlib.__all__ == optuna_tpu.visualization.matplotlib.__all__
    assert optuna_tpu_torch.visualization.is_available() == optuna_tpu.visualization.is_available()
    assert optuna_tpu_torch.visualization.matplotlib.is_available() == optuna_tpu.visualization.matplotlib.is_available()


def test_pareto_front_validation_matches_the_reference():
    for mod in PACKAGES:
        study = _multi(mod)
        with pytest.raises(ValueError, match="permutation"):
            mod.visualization.plot_pareto_front(study, axis_order=[0, 0])
        with pytest.raises(ValueError, match="target_names"):
            mod.visualization.plot_pareto_front(study, targets=lambda t: t.values)
        with pytest.raises(ValueError):
            mod.visualization.plot_contour(_single(mod), params=["x"])


# --------------------------------------------------------- the matplotlib mirror


@pytest.fixture
def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, every figure closed after."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


def _artists(result) -> list:
    """Plain data of every Axes a mirror plot drew."""
    axes = np.ravel(np.asarray(result, dtype=object)) if not hasattr(result, "get_lines") else [result]
    out = []
    for ax in axes:
        if ax is None:
            continue
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "scales": (ax.get_xscale(), ax.get_yscale()),
            "lines": [_norm(line.get_xydata()) for line in ax.get_lines()],
            "offsets": [_norm(c.get_offsets()) for c in ax.collections if hasattr(c, "get_offsets")],
            "patches": [_norm([p.get_x(), p.get_y(), p.get_width(), p.get_height()])
                        for p in ax.patches if hasattr(p, "get_width")],
            "texts": [t.get_text() for t in ax.texts],
            "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
            "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
        })
    return out


MIRROR_CASES = {
    "optimization_history": ("plot_optimization_history", single, {}),
    "intermediate_values": ("plot_intermediate_values", single, {}),
    "edf": ("plot_edf", single, {}),
    "slice": ("plot_slice", single, {}),
    "contour": ("plot_contour", single, {"params": ["x", "lr"]}),
    "contour_matrix": ("plot_contour", single, {"params": ["x", "lr", "k"]}),
    "rank": ("plot_rank", single, {"params": ["x", "c"]}),
    "parallel_coordinate": ("plot_parallel_coordinate", single, {}),
    "timeline": ("plot_timeline", single, {}),
    "pareto_front": ("plot_pareto_front", multi, {}),
    "pareto_front_3d": ("plot_pareto_front", multi3, {"target_names": ["f0", "f1", "f2"]}),
    "hypervolume_history": ("plot_hypervolume_history", multi, {"reference_point": [1.5, 0.5]}),
}


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_matplotlib_mirror_draws_what_the_reference_draws(case, pyplot):
    fn, build, kwargs = MIRROR_CASES[case]
    ref = _artists(getattr(optuna_tpu.visualization.matplotlib, fn)(build(optuna_tpu), **kwargs))
    port = _artists(getattr(optuna_tpu_torch.visualization.matplotlib, fn)(build(optuna_tpu_torch), **kwargs))
    assert port == ref and port


def test_matplotlib_mirror_importances_and_terminator_plot(pyplot):
    drawn = []
    for mod in PACKAGES:
        t = mod.terminator
        drawn.append(_artists(mod.visualization.matplotlib.plot_param_importances(
            _single(mod), evaluator=mod.importance.PedAnovaImportanceEvaluator())))
        drawn.append(_artists(mod.visualization.matplotlib.plot_terminator_improvement(
            _single(mod), improvement_evaluator=t.BestValueStagnationEvaluator(4),
            error_evaluator=t.MedianErrorEvaluator(warm_up_trials=2, n_min_trials=5), min_n_trials=8)))
    assert drawn[2:] == drawn[:2]
    mirror = optuna_tpu_torch.visualization.matplotlib
    ax = mirror.plot_param_importances(_single(optuna_tpu_torch), device=CPU)
    assert [t.get_text() for t in ax.get_yticklabels()][-1] == "x"
    ax = mirror.plot_hypervolume_history(_multi(optuna_tpu_torch, n=32, seed=6, m=5, constraints=False),
                                         [1.5, 1.5, 1.5, 1.5, -1.5], device=CPU)
    assert len(ax.get_lines()[0].get_xydata()) == 32
