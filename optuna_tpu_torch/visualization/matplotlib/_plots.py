"""The 12 study plots, matplotlib edition.

Feature parity targets: the reference's ``optuna/visualization/matplotlib/``
mirror. Every plot renders from the same backend-neutral builders as the
plotly-schema backend (:mod:`optuna_tpu_torch.visualization._data`) — contour
grid interpolation, log and categorical axes, error-bar aggregation,
constraint-aware Pareto fronts — so the two backends show the same data by
construction. Each function returns the Axes (or array of Axes) so callers
can style/save.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np

from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._state import TrialState
from optuna_tpu_torch.visualization import _data as D

if TYPE_CHECKING:
    from matplotlib.axes import Axes

    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)


def _axes(ax=None) -> "Axes":
    import matplotlib.pyplot as plt

    if ax is not None:
        return ax
    _, ax = plt.subplots()
    return ax


def _studies(study) -> list:
    # A single Study quacks with get_trials; anything else is an iterable of
    # studies (list, tuple, generator, ...).
    return [study] if hasattr(study, "get_trials") else list(study)


# ------------------------------------------------------------------- history


def plot_optimization_history(
    study: "Study",
    *,
    target: Callable | None = None,
    target_name: str = "Objective Value",
    error_bar: bool = False,
    ax=None,
) -> "Axes":
    ax = _axes(ax)
    studies = _studies(study)
    target_name = D.resolve_target_name(studies, target, target_name)
    series = D.optimization_history_data(studies, target, target_name, error_bar)
    multi = len(series) > 1
    for s in series:
        # s.stdev marks the aggregated error-bar series (single combined
        # series); per-study labels only matter for true multi-study plots.
        label = f"{target_name} ({s.study_name})" if multi else target_name
        if s.stdev is not None:
            ax.errorbar(
                s.trial_numbers, s.values, yerr=s.stdev, fmt="o", ms=3,
                alpha=0.6, label=label,
            )
        else:
            ax.scatter(s.trial_numbers, s.values, s=12, alpha=0.6, label=label)
        if s.best_values is not None:
            best_label = f"Best Value ({s.study_name})" if multi else "Best Value"
            line_kwargs = {} if multi else {"color": "crimson"}
            ax.plot(s.trial_numbers, s.best_values, label=best_label, **line_kwargs)
    ax.set_xlabel("Trial")
    ax.set_ylabel(target_name)
    ax.set_title("Optimization History Plot")
    ax.legend()
    return ax


def plot_intermediate_values(study: "Study", *, ax=None) -> "Axes":
    ax = _axes(ax)
    for s in D.intermediate_values_data(study):
        color = "tab:orange" if s.state == TrialState.PRUNED else None
        ax.plot(s.steps, s.values, alpha=0.4, color=color, label=f"Trial{s.trial_number}")
    ax.set_xlabel("Step")
    ax.set_ylabel("Intermediate Value")
    ax.set_title("Intermediate Values Plot")
    return ax


def plot_edf(
    study: "Study | Sequence[Study]", *, target: Callable | None = None,
    target_name: str = "Objective Value", ax=None
) -> "Axes":
    ax = _axes(ax)
    for s in D.edf_data(_studies(study), target):
        ax.plot(s.x, s.y, drawstyle="steps-post", label=s.study_name)
    ax.set_xlabel(target_name)
    ax.set_ylabel("Cumulative Probability")
    ax.set_ylim(0, 1)
    ax.set_title("Empirical Distribution Function Plot")
    ax.legend()
    return ax


# --------------------------------------------------------------- param plots


def _apply_x_axis(ax: "Axes", is_log: bool, is_categorical: bool, labels: list[str]):
    if is_log:
        ax.set_xscale("log")
    if is_categorical and labels:
        ax.set_xticks(range(len(labels)))
        ax.set_xticklabels(labels)


def plot_slice(
    study: "Study", params: list[str] | None = None, *, target: Callable | None = None,
    target_name: str = "Objective Value",
) -> "np.ndarray":
    import matplotlib.pyplot as plt

    subplots = D.slice_data(study, params, target)
    n = max(len(subplots), 1)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), sharey=True)
    axes = np.atleast_1d(axes)
    sc = None
    for ax, sp in zip(axes, subplots):
        xs = sp.x_indices if sp.is_categorical else sp.x
        sc = ax.scatter(xs, sp.y, s=12, alpha=0.6, c=sp.trial_numbers, cmap="Blues")
        _apply_x_axis(ax, sp.is_log, sp.is_categorical, sp.labels)
        ax.set_xlabel(sp.param)
    axes[0].set_ylabel(target_name)
    if sc is not None:
        fig.colorbar(sc, ax=axes[-1], label="Trial")
    fig.suptitle("Slice Plot")
    return axes


def plot_contour(
    study: "Study", params: list[str] | None = None, *, target: Callable | None = None,
    target_name: str = "Objective Value", ax=None
) -> "Axes | np.ndarray":
    import matplotlib.pyplot as plt

    matrix = D.contour_data(study, params, target)
    n = len(matrix)
    # Better values render darker regardless of direction (reference
    # ``_utils.py:169`` reverse-scale rule).
    cmap = "Blues_r" if D.is_reverse_scale(study, target) else "Blues"

    def render(ax: "Axes", pair: D.ContourPair, colorbar: bool) -> None:
        masked = np.ma.masked_invalid(pair.grid_z)
        if masked.count():
            cf = ax.contourf(
                pair.grid_x, pair.grid_y, masked, levels=14, cmap=cmap, alpha=0.9
            )
            if colorbar:
                plt.colorbar(cf, ax=ax, label=target_name)
        ax.scatter(pair.x_points, pair.y_points, c="black", s=8)
        ax.set_xlim(*pair.x.range)
        ax.set_ylim(*pair.y.range)
        ax.set_xlabel(f"log10({pair.x.param})" if pair.x.is_log else pair.x.param)
        ax.set_ylabel(f"log10({pair.y.param})" if pair.y.is_log else pair.y.param)
        if pair.x.is_categorical:
            ax.set_xticks(range(len(pair.x.labels)))
            ax.set_xticklabels(pair.x.labels)
        if pair.y.is_categorical:
            ax.set_yticks(range(len(pair.y.labels)))
            ax.set_yticklabels(pair.y.labels)

    if n == 2:
        ax = _axes(ax)
        render(ax, matrix[1][0], colorbar=True)
        ax.set_title("Contour Plot")
        return ax
    fig, axes = plt.subplots(n, n, figsize=(3 * n, 3 * n))
    for r in range(n):
        for c in range(n):
            pair = matrix[r][c]
            if pair is None:
                axes[r][c].axis("off")
            else:
                render(axes[r][c], pair, colorbar=False)
    fig.suptitle("Contour Plot")
    return axes


def plot_rank(
    study: "Study", params: list[str] | None = None, *, target: Callable | None = None,
    target_name: str = "Objective Value",
) -> "np.ndarray":
    import matplotlib.pyplot as plt

    subplots = D.rank_data(study, params, target)
    n = max(len(subplots), 1)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), sharey=True)
    axes = np.atleast_1d(axes)
    sc = None
    for ax, sp in zip(axes, subplots):
        xs = sp.x_indices if sp.is_categorical else sp.x
        _apply_x_axis(ax, sp.is_log, sp.is_categorical, sp.labels)
        sc = ax.scatter(xs, sp.y, c=sp.colors, cmap="coolwarm", vmin=0.0, vmax=1.0, s=14)
        ax.set_xlabel(sp.param)
    axes[0].set_ylabel(target_name)
    if sc is not None:
        fig.colorbar(sc, ax=axes[-1], label="Rank")
    fig.suptitle(f"Rank ({target_name})")
    return axes


def plot_parallel_coordinate(
    study: "Study", params: list[str] | None = None, *, target: Callable | None = None,
    target_name: str = "Objective Value", ax=None
) -> "Axes":
    import matplotlib.cm as cm

    ax = _axes(ax)
    axes_data, colors = D.parallel_coordinate_data(study, params, target, target_name)
    if not colors:
        return ax
    cmin, cmax = min(colors), max(colors)
    span = (cmax - cmin) or 1.0

    # Min-max scale every axis into [0, 1] for a shared vertical scale.
    scaled = []
    for a in axes_data:
        lo, hi = a.range
        width = (hi - lo) or 1.0
        scaled.append([(v - lo) / width for v in a.values])
    mat = np.asarray(scaled).T  # (n_trials, n_axes)
    for i in range(mat.shape[0]):
        ax.plot(
            range(mat.shape[1]), mat[i],
            color=cm.Blues(1.0 - (colors[i] - cmin) / span), alpha=0.4,
        )
    ax.set_xticks(range(len(axes_data)))
    ax.set_xticklabels([a.label for a in axes_data], rotation=30)
    # Annotate categorical/log tick mappings on their vertical axes, in the
    # same data coordinates the polylines use (scaled to [0, 1]).
    ax.set_ylim(0.0, 1.0)
    for xi, a in enumerate(axes_data):
        if a.tick_labels:
            lo, hi = a.range
            width = (hi - lo) or 1.0
            for tv, tl in zip(a.tick_values, a.tick_labels):
                y = (tv - lo) / width
                if 0.0 <= y <= 1.0:
                    ax.annotate(tl, (xi, y), fontsize=6, xycoords="data")
    ax.set_yticks([])
    ax.set_title("Parallel Coordinate Plot")
    return ax


def plot_param_importances(
    study: "Study", *, evaluator=None, params: list[str] | None = None,
    target: Callable | None = None, target_name: str = "Objective Value", ax=None, device=None,
) -> "Axes":
    import matplotlib.pyplot as plt

    ax = _axes(ax)
    infos = D.importances_data(study, evaluator, params, target, target_name, device)
    # Multi-objective: grouped horizontal bars, one color per objective
    # (reference ``matplotlib/_param_importances.py:95-126``). Every
    # objective's bars share ONE param order (objective 0's ranking) so a
    # y position always means the same hyperparameter.
    names = list(infos[0][1].keys())[::-1]
    height = 0.8 / len(infos)
    cmap = plt.get_cmap("tab20c")
    pos = np.arange(len(names), dtype=float)
    for obj_id, (obj_name, importances) in enumerate(infos):
        vals = [importances[n] for n in names]
        offset = height * obj_id
        ax.barh(
            pos + offset, vals, height=height, align="center", label=obj_name,
            color=cmap(obj_id) if len(infos) > 1 else "steelblue",
        )
        for y, v in zip(pos + offset, vals):
            ax.text(v, y, f" {v:.2f}" if v >= 0.01 else " <0.01", va="center", fontsize=8)
    ax.set_yticks(list(pos + (0.8 - height) / 2 if len(infos) > 1 else pos))
    ax.set_yticklabels(names)
    xlabel = infos[0][0] if len(infos) == 1 else "Objective Value"
    ax.set_xlabel(f"Importance for {xlabel}")
    ax.set_ylabel("Hyperparameter")
    ax.set_title("Hyperparameter Importances")
    if len(infos) > 1:
        ax.legend(loc="best")
    return ax


# ----------------------------------------------------------- multi-objective


def plot_pareto_front(
    study: "Study", *, target_names: list[str] | None = None, ax=None,
    include_dominated_trials: bool = True, axis_order: list[int] | None = None,
    constraints_func: Callable | None = None, targets: Callable | None = None,
) -> "Axes":
    pf = D.pareto_front_data(
        study, target_names, include_dominated_trials, targets, axis_order,
        constraints_func,
    )
    # Plot dimensionality follows the actual value vectors: a `targets`
    # callable may project an N-objective study down to 2 or 3 axes.
    order = pf.axis_order
    n_axes = len(order)
    if n_axes not in (2, 3):
        raise ValueError(f"plot_pareto_front renders 2 or 3 axes, got {n_axes}.")
    trial_label = "Feasible Trial" if pf.infeasible_values else "Trial"
    if n_axes == 3:
        import matplotlib.pyplot as plt

        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
        elif not hasattr(ax, "zaxis"):
            raise ValueError(
                "plot_pareto_front with 3 axes needs a 3D Axes "
                "(add_subplot(projection='3d'))."
            )

        def scat3(vals, **kw):
            if vals:
                arr = np.asarray(vals)[:, order]
                ax.scatter(*arr.T, **kw)

        scat3(pf.infeasible_values, s=8, alpha=0.4, label="Infeasible Trial", color="#cccccc")
        scat3(pf.other_values, s=12, alpha=0.4, label=trial_label, color="steelblue")
        scat3(pf.best_values, s=22, label="Best Trial", color="crimson")
        if len(pf.target_names) > 2:
            ax.set_zlabel(pf.target_names[order[2]])
    else:
        ax = _axes(ax)

        def scat(vals, **kw):
            if vals:
                arr = np.asarray(vals)
                ax.scatter(arr[:, order[0]], arr[:, order[1]], **kw)

        scat(pf.infeasible_values, s=8, alpha=0.4, label="Infeasible Trial", color="#cccccc")
        scat(pf.other_values, s=12, alpha=0.4, label=trial_label, color="steelblue")
        scat(pf.best_values, s=22, label="Best Trial", color="crimson")
    ax.set_xlabel(pf.target_names[order[0]])
    ax.set_ylabel(pf.target_names[order[1]])
    ax.set_title("Pareto-front Plot")
    ax.legend()
    return ax


def plot_hypervolume_history(
    study: "Study", reference_point: Sequence[float], *, ax=None, device=None
) -> "Axes":
    from optuna_tpu_torch.hypervolume import compute_hypervolume
    from optuna_tpu_torch.study._multi_objective import _normalize_values

    ax = _axes(ax)
    trials = D._completed(study)
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
    ax.plot([t.number for t in trials], hv, marker="o", ms=3)
    ax.set_xlabel("Trial")
    ax.set_ylabel("Hypervolume")
    ax.set_title("Hypervolume History Plot")
    return ax


# ------------------------------------------------------------ ops/diagnostics


def plot_timeline(study: "Study", *, ax=None) -> "Axes":
    import matplotlib.dates as mdates
    import matplotlib.patches as mpatches

    ax = _axes(ax)
    colors = {
        TrialState.COMPLETE: "tab:blue",
        TrialState.PRUNED: "tab:orange",
        TrialState.FAIL: "tab:red",
        TrialState.RUNNING: "tab:green",
        TrialState.WAITING: "tab:gray",
    }
    for bar in D.timeline_data(study):
        start = mdates.date2num(bar.start)
        end = mdates.date2num(bar.complete)
        ax.barh(
            bar.number, max(end - start, 1e-9), left=start,
            color=colors[bar.state], height=0.8,
        )
    ax.xaxis_date()
    ax.set_xlabel("Datetime")
    ax.set_ylabel("Trial")
    ax.set_title("Timeline Plot")
    handles = [mpatches.Patch(color=c, label=s.name) for s, c in colors.items()]
    ax.legend(handles=handles, fontsize=7)
    return ax


def plot_terminator_improvement(
    study: "Study", *, improvement_evaluator=None, error_evaluator=None,
    min_n_trials: int = 20, ax=None, device=None,
) -> "Axes":
    from optuna_tpu_torch.terminator import MedianErrorEvaluator, RegretBoundEvaluator

    ax = _axes(ax)
    improvement_evaluator = improvement_evaluator or RegretBoundEvaluator(device=device)
    error_evaluator = error_evaluator or MedianErrorEvaluator()
    trials = D._completed(study)
    xs, improvements, errors = [], [], []
    for i in range(min_n_trials, len(trials) + 1):
        sub = trials[:i]
        xs.append(sub[-1].number)
        improvements.append(improvement_evaluator.evaluate(sub, study.direction))
        try:
            errors.append(error_evaluator.evaluate(sub, study.direction))
        except ValueError:
            errors.append(float("nan"))
    ax.plot(xs, improvements, label="Improvement", marker="o", ms=3)
    ax.plot(xs, errors, label="Error", marker="x", ms=3)
    ax.set_xlabel("Trial")
    ax.set_ylabel("Improvement / Error")
    ax.set_yscale("symlog")
    ax.set_title("Terminator Improvement Plot")
    ax.legend()
    return ax
