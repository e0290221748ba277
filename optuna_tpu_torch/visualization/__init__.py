"""Visualization (reference ``optuna/visualization/__init__.py:1-32``).

The reference's primary backend is plotly with a matplotlib mirror. Every
``plot_*`` here builds a **plotly-schema figure** — ``{"data": [...],
"layout": {...}}`` — from the backend-neutral builders in
:mod:`optuna_tpu_torch.visualization._data`. When plotly is importable the dict
is wrapped into a real ``plotly.graph_objects.Figure`` (so ``.show()`` et
al. work); without plotly the plain dict is returned, which is the same
schema plotly itself serializes to and is what the tests assert against.
The matplotlib mirror (:mod:`optuna_tpu_torch.visualization.matplotlib`) renders
from the same builders.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from optuna_tpu_torch.visualization import matplotlib  # noqa: F401  (the mirror backend)
from optuna_tpu_torch.visualization import _data as D

__all__ = [
    "plot_contour",
    "plot_edf",
    "plot_hypervolume_history",
    "plot_intermediate_values",
    "plot_optimization_history",
    "plot_parallel_coordinate",
    "plot_param_importances",
    "plot_pareto_front",
    "plot_rank",
    "plot_slice",
    "plot_terminator_improvement",
    "plot_timeline",
    "is_available",
    "matplotlib",
]

_STATE_COLORS = {
    "COMPLETE": "blue",
    "PRUNED": "orange",
    "FAIL": "red",
    "RUNNING": "green",
    "WAITING": "gray",
}


def is_available() -> bool:
    try:
        import plotly  # noqa: F401

        return True
    except ImportError:
        return False


def _figure(data: list[dict], layout: dict):
    """plotly Figure when plotly exists, else the raw figure dict (same
    schema plotly serializes to)."""
    fig = {"data": data, "layout": layout}
    if is_available():
        import plotly.graph_objects as go

        return go.Figure(fig)
    return fig


def _axis(title: str, *, log: bool = False, categories: list[str] | None = None) -> dict:
    ax: dict[str, Any] = {"title": {"text": title}}
    if log:
        ax["type"] = "log"
    if categories is not None:
        ax["tickvals"] = list(range(len(categories)))
        ax["ticktext"] = categories
    return ax


# ----------------------------------------------------------------- histories


def plot_optimization_history(
    study,
    *,
    target: Callable | None = None,
    target_name: str = "Objective Value",
    error_bar: bool = False,
):
    studies = [study] if not isinstance(study, (list, tuple)) else list(study)
    target_name = D.resolve_target_name(studies, target, target_name)
    series = D.optimization_history_data(studies, target, target_name, error_bar)
    data: list[dict] = []
    for s in series:
        marker: dict[str, Any] = {}
        trace: dict[str, Any] = {
            "type": "scatter",
            "mode": "markers",
            "name": f"{target_name} ({s.study_name})" if len(series) > 1 or error_bar
            else target_name,
            "x": s.trial_numbers,
            "y": s.values,
            "marker": marker,
        }
        if s.stdev is not None:
            trace["error_y"] = {"type": "data", "array": s.stdev, "visible": True}
        data.append(trace)
        if s.best_values is not None:
            data.append(
                {
                    "type": "scatter",
                    "mode": "lines",
                    "name": f"Best Value ({s.study_name})" if len(series) > 1
                    else "Best Value",
                    "x": s.trial_numbers,
                    "y": s.best_values,
                }
            )
    layout = {
        "title": {"text": "Optimization History Plot"},
        "xaxis": _axis("Trial"),
        "yaxis": _axis(target_name),
    }
    return _figure(data, layout)


def plot_intermediate_values(study):
    data = [
        {
            "type": "scatter",
            "mode": "lines+markers",
            "name": f"Trial{s.trial_number}",
            "x": s.steps,
            "y": s.values,
            "line": {"color": _STATE_COLORS.get(s.state.name)}
            if s.state.name == "PRUNED"
            else {},
        }
        for s in D.intermediate_values_data(study)
    ]
    layout = {
        "title": {"text": "Intermediate Values Plot"},
        "xaxis": _axis("Step"),
        "yaxis": _axis("Intermediate Value"),
    }
    return _figure(data, layout)


def plot_edf(
    study, *, target: Callable | None = None, target_name: str = "Objective Value"
):
    studies = [study] if not isinstance(study, (list, tuple)) else list(study)
    data = [
        {
            "type": "scatter",
            "mode": "lines",
            "name": s.study_name,
            "x": s.x.tolist(),
            "y": s.y.tolist(),
        }
        for s in D.edf_data(studies, target)
    ]
    layout = {
        "title": {"text": "Empirical Distribution Function Plot"},
        "xaxis": _axis(target_name),
        "yaxis": {"title": {"text": "Cumulative Probability"}, "range": [0, 1]},
    }
    return _figure(data, layout)


def plot_hypervolume_history(study, reference_point: Sequence[float], *, device=None):
    """One hypervolume a prefix of the COMPLETE trials, through the routed
    :func:`~optuna_tpu_torch.hypervolume.compute_hypervolume` (large fronts
    on ``device``; ``None``: the card)."""
    from optuna_tpu_torch.hypervolume import compute_hypervolume
    from optuna_tpu_torch.study._multi_objective import _normalize_values
    from optuna_tpu_torch.study._study_direction import StudyDirection
    from optuna_tpu_torch.trial._state import TrialState

    trials = [t for t in study.get_trials(deepcopy=False) if t.state == TrialState.COMPLETE]
    ref = np.asarray(reference_point, dtype=np.float64)
    values = _normalize_values(
        np.asarray([t.values for t in trials], dtype=np.float64), study.directions
    )
    signs = np.asarray(
        [-1.0 if d == StudyDirection.MAXIMIZE else 1.0 for d in study.directions]
    )
    hv = [
        compute_hypervolume(values[: i + 1], ref * signs, device=device) for i in range(len(trials))
    ]
    data = [
        {
            "type": "scatter",
            "mode": "lines+markers",
            "name": "Hypervolume",
            "x": [t.number for t in trials],
            "y": hv,
        }
    ]
    layout = {
        "title": {"text": "Hypervolume History Plot"},
        "xaxis": _axis("Trial"),
        "yaxis": _axis("Hypervolume"),
    }
    return _figure(data, layout)


# -------------------------------------------------------------- param plots


def plot_slice(
    study,
    params: list[str] | None = None,
    *,
    target: Callable | None = None,
    target_name: str = "Objective Value",
):
    subplots = D.slice_data(study, params, target)
    data = []
    layout: dict[str, Any] = {"title": {"text": "Slice Plot"}}
    for i, sp in enumerate(subplots, start=1):
        suffix = "" if i == 1 else str(i)
        data.append(
            {
                "type": "scatter",
                "mode": "markers",
                "name": sp.param,
                # Categorical x uses the builder's index mapping so both
                # backends share one category ordering.
                "x": sp.x_indices if sp.is_categorical else sp.x,
                "y": sp.y,
                "xaxis": f"x{suffix}",
                "yaxis": f"y{suffix}",
                "marker": {
                    "color": sp.trial_numbers,
                    "colorscale": "Blues",
                    "colorbar": {"title": {"text": "Trial"}} if i == len(subplots) else None,
                },
            }
        )
        n = len(subplots)
        # Shrink the gap for wide studies so domains stay positive-width
        # inside [0, 1] at any parameter count.
        gap = min(0.05, 0.25 / max(n, 1))
        w = max((1.0 - gap * (n - 1)) / n, 1e-3)
        left = (i - 1) * (w + gap)
        layout[f"xaxis{suffix}"] = {
            **_axis(
                sp.param, log=sp.is_log,
                categories=sp.labels if sp.is_categorical else None,
            ),
            "domain": [left, left + w],
            "anchor": f"y{suffix}",
        }
        layout[f"yaxis{suffix}"] = {
            **(_axis(target_name) if i == 1 else {"title": {}}),
            "anchor": f"x{suffix}",
        }
    return _figure(data, layout)


def plot_contour(
    study,
    params: list[str] | None = None,
    *,
    target: Callable | None = None,
    target_name: str = "Objective Value",
):
    matrix = D.contour_data(study, params, target)
    n = len(matrix)
    data: list[dict] = []
    layout: dict[str, Any] = {"title": {"text": "Contour Plot"}}
    reverse = D.is_reverse_scale(study, target)

    def add_cell(pair: D.ContourPair, ax_idx: int, show_scale: bool) -> None:
        suffix = "" if ax_idx == 1 else str(ax_idx)
        data.append(
            {
                "type": "contour",
                "x": pair.grid_x.tolist(),
                "y": pair.grid_y.tolist(),
                "z": [
                    [None if np.isnan(v) else float(v) for v in row]
                    for row in pair.grid_z
                ],
                "colorscale": "Blues",
                "reversescale": reverse,
                "connectgaps": True,
                "showscale": show_scale,
                "colorbar": {"title": {"text": target_name}} if show_scale else None,
                "line": {"smoothing": 1.3},
                "xaxis": f"x{suffix}",
                "yaxis": f"y{suffix}",
            }
        )
        data.append(
            {
                "type": "scatter",
                "mode": "markers",
                "x": pair.x_points,
                "y": pair.y_points,
                "marker": {"color": "black", "size": 4},
                "showlegend": False,
                "xaxis": f"x{suffix}",
                "yaxis": f"y{suffix}",
            }
        )
        layout[f"xaxis{suffix}"] = {
            **_axis(pair.x.param, categories=pair.x.labels if pair.x.is_categorical else None),
            "range": list(pair.x.range),
            "anchor": f"y{suffix}",
        }
        layout[f"yaxis{suffix}"] = {
            **_axis(pair.y.param, categories=pair.y.labels if pair.y.is_categorical else None),
            "range": list(pair.y.range),
            "anchor": f"x{suffix}",
        }
        if pair.x.is_log:
            # grid coords are log10-mapped; expose plotly log axis over the
            # original values instead of the mapped ones.
            layout[f"xaxis{suffix}"]["type"] = "linear"
            layout[f"xaxis{suffix}"]["title"]["text"] = f"log10({pair.x.param})"
        if pair.y.is_log:
            layout[f"yaxis{suffix}"]["type"] = "linear"
            layout[f"yaxis{suffix}"]["title"]["text"] = f"log10({pair.y.param})"

    if n == 2:
        add_cell(matrix[1][0], 1, True)  # y = second param, x = first
    else:
        idx = 1
        for r in range(n):
            for c in range(n):
                pair = matrix[r][c]
                if pair is not None:
                    add_cell(pair, idx, show_scale=(r == 0 and c == 1))
                idx += 1
    return _figure(data, layout)


def plot_rank(
    study,
    params: list[str] | None = None,
    *,
    target: Callable | None = None,
    target_name: str = "Objective Value",
):
    subplots = D.rank_data(study, params, target)
    data = []
    layout: dict[str, Any] = {"title": {"text": f"Rank ({target_name})"}}
    for i, sp in enumerate(subplots, start=1):
        suffix = "" if i == 1 else str(i)
        data.append(
            {
                "type": "scatter",
                "mode": "markers",
                "name": sp.param,
                "x": sp.x_indices if sp.is_categorical else sp.x,
                "y": sp.y,
                "xaxis": f"x{suffix}",
                "yaxis": f"y{suffix}",
                "marker": {
                    "color": sp.colors,
                    "colorscale": "RdYlBu_r",
                    "cmin": 0.0,
                    "cmax": 1.0,
                    "colorbar": {"title": {"text": "Rank"}} if i == len(subplots) else None,
                },
                "text": [f"Trial {k}" for k in sp.trial_numbers],
            }
        )
        layout[f"xaxis{suffix}"] = {
            **_axis(
                sp.param, log=sp.is_log,
                categories=sp.labels if sp.is_categorical else None,
            ),
            "anchor": f"y{suffix}",
        }
        layout[f"yaxis{suffix}"] = {"anchor": f"x{suffix}"}
    return _figure(data, layout)


def plot_parallel_coordinate(
    study,
    params: list[str] | None = None,
    *,
    target: Callable | None = None,
    target_name: str = "Objective Value",
):
    axes, colors = D.parallel_coordinate_data(study, params, target, target_name)
    dims = []
    for ax in axes:
        dim: dict[str, Any] = {
            "label": ax.label,
            "values": ax.values,
            "range": list(ax.range),
        }
        if ax.tick_values:
            dim["tickvals"] = ax.tick_values
            dim["ticktext"] = ax.tick_labels
        dims.append(dim)
    data = [
        {
            "type": "parcoords",
            "dimensions": dims,
            "line": {
                "color": colors,
                "colorscale": "Blues",
                "showscale": True,
                "reversescale": True,
            },
        }
    ]
    return _figure(data, {"title": {"text": "Parallel Coordinate Plot"}})


def plot_param_importances(
    study,
    *,
    evaluator=None,
    params: list[str] | None = None,
    target: Callable | None = None,
    target_name: str = "Objective Value",
    device=None,
):
    """Importances per parameter; with no ``evaluator``, fANOVA with its
    forest on ``device`` (``None``: the card)."""
    infos = D.importances_data(study, evaluator, params, target, target_name, device)
    data = []
    for obj_name, importances in infos:
        names = list(importances.keys())[::-1]
        vals = [importances[n] for n in names]
        data.append(
            {
                "type": "bar",
                "orientation": "h",
                "x": vals,
                "y": names,
                "text": [f"{v:.2f}" if v >= 0.01 else "<0.01" for v in vals],
                "name": obj_name,
            }
        )
    xlabel = infos[0][0] if len(infos) == 1 else "Objective Value"
    layout = {
        "title": {"text": "Hyperparameter Importances"},
        "xaxis": _axis(f"Importance for {xlabel}"),
        "yaxis": _axis("Hyperparameter"),
    }
    if len(infos) > 1:
        layout["barmode"] = "group"
    return _figure(data, layout)


# ------------------------------------------------------------ multi-objective


def plot_pareto_front(
    study,
    *,
    target_names: list[str] | None = None,
    include_dominated_trials: bool = True,
    axis_order: list[int] | None = None,
    constraints_func: Callable | None = None,
    targets: Callable | None = None,
):
    pf = D.pareto_front_data(
        study, target_names, include_dominated_trials, targets, axis_order,
        constraints_func,
    )
    order = pf.axis_order
    is_3d = len(order) == 3

    def trace(values, numbers, name, color, size):
        t: dict[str, Any] = {
            "type": "scatter3d" if is_3d else "scatter",
            "mode": "markers",
            "name": name,
            "marker": {"color": color, "size": size},
            "text": [f"Trial {n}" for n in numbers],
            "x": [v[order[0]] for v in values],
            "y": [v[order[1]] for v in values],
        }
        if is_3d:
            t["z"] = [v[order[2]] for v in values]
        return t

    data = []
    trial_label = "Trial"
    if pf.infeasible_values:
        data.append(
            trace(pf.infeasible_values, pf.infeasible_numbers, "Infeasible Trial", "#cccccc", 4)
        )
        trial_label = "Feasible Trial"
    if pf.other_values:
        data.append(trace(pf.other_values, pf.other_numbers, trial_label, "blue", 4))
    data.append(trace(pf.best_values, pf.best_numbers, "Best Trial", "red", 6))
    layout: dict[str, Any] = {"title": {"text": "Pareto-front Plot"}}
    if is_3d:
        layout["scene"] = {
            "xaxis": _axis(pf.target_names[order[0]]),
            "yaxis": _axis(pf.target_names[order[1]]),
            "zaxis": _axis(pf.target_names[order[2]]),
        }
    else:
        layout["xaxis"] = _axis(pf.target_names[order[0]])
        layout["yaxis"] = _axis(pf.target_names[order[1]])
    return _figure(data, layout)


# ------------------------------------------------------------ ops/diagnostics


def plot_timeline(study):
    bars = D.timeline_data(study)
    by_state: dict[str, list[D.TimelineBar]] = {}
    for b in bars:
        by_state.setdefault(b.state.name, []).append(b)
    data = []
    for state, group in by_state.items():
        data.append(
            {
                "type": "bar",
                "orientation": "h",
                "name": state,
                "marker": {"color": _STATE_COLORS.get(state, "black")},
                "base": [b.start.isoformat() for b in group],
                "x": [max((b.complete - b.start).total_seconds(), 1e-9) * 1000.0
                      for b in group],
                "y": [b.number for b in group],
                "text": [b.hover for b in group],
            }
        )
    layout = {
        "title": {"text": "Timeline Plot"},
        "xaxis": {"title": {"text": "Datetime"}, "type": "date"},
        "yaxis": _axis("Trial"),
        "barmode": "overlay",
    }
    return _figure(data, layout)


def plot_terminator_improvement(
    study,
    *,
    improvement_evaluator=None,
    error_evaluator=None,
    min_n_trials: int = 20,
    device=None,
):
    """Improvement and error a prefix from ``min_n_trials`` on; the default
    improvement evaluator fits its GP on ``device`` (``None``: the card)."""
    from optuna_tpu_torch.terminator import MedianErrorEvaluator, RegretBoundEvaluator
    from optuna_tpu_torch.trial._state import TrialState

    improvement_evaluator = improvement_evaluator or RegretBoundEvaluator(device=device)
    error_evaluator = error_evaluator or MedianErrorEvaluator()
    trials = [t for t in study.get_trials(deepcopy=False) if t.state == TrialState.COMPLETE]
    xs, improvements, errors = [], [], []
    for i in range(min_n_trials, len(trials) + 1):
        sub = trials[:i]
        xs.append(sub[-1].number)
        improvements.append(improvement_evaluator.evaluate(sub, study.direction))
        try:
            errors.append(error_evaluator.evaluate(sub, study.direction))
        except ValueError:
            errors.append(float("nan"))
    data = [
        {"type": "scatter", "mode": "lines+markers", "name": "Improvement",
         "x": xs, "y": improvements},
        {"type": "scatter", "mode": "lines+markers", "name": "Error",
         "x": xs, "y": errors},
    ]
    layout = {
        "title": {"text": "Terminator Improvement Plot"},
        "xaxis": _axis("Trial"),
        "yaxis": _axis("Improvement / Error"),
    }
    return _figure(data, layout)
