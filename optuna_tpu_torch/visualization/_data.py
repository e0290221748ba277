"""Backend-neutral plot-data builders.

Each ``*_data`` function computes everything a figure needs — series,
grids, axis types, tick mappings — as plain Python/NumPy values. The
plotly-schema bodies in :mod:`optuna_tpu_torch.visualization` and the matplotlib
mirror both render from these, so the two backends cannot drift and the
*math* (contour interpolation, EDF grids, rank normalization, infeasibility
masks) is unit-testable without any plotting library installed.

Feature parity targets: ``optuna/visualization/_optimization_history.py``
(error-bar mode, multi-study), ``_contour.py`` (grid interpolation, log and
categorical axes, param-pair matrix), ``_parallel_coordinate.py``
(categorical tick mapping, log dims), ``_rank.py`` (normalized rank
coloring), ``_edf.py`` (shared x-grid), ``_pareto_front.py`` (2D/3D,
constraint coloring), ``_timeline.py``, ``_slice.py``.
"""

from __future__ import annotations

import datetime
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from optuna_tpu_torch.distributions import CategoricalDistribution
from optuna_tpu_torch.study._multi_objective import (
    _get_pareto_front_trials,
    _get_pareto_front_trials_by_trials,
)
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

PADDING_RATIO = 0.05
CONTOUR_POINTS = 100


def _completed(study) -> list[FrozenTrial]:
    return [t for t in study.get_trials(deepcopy=False) if t.state == TrialState.COMPLETE]


def _value_of(trial: FrozenTrial, target: Callable | None) -> float:
    return float(target(trial)) if target is not None else float(trial.value)


def _intersection_params(trials: list[FrozenTrial]) -> list[str]:
    from optuna_tpu_torch.search_space import intersection_search_space

    return [k for k, v in intersection_search_space(trials).items() if not v.single()]


def _is_log(trials: list[FrozenTrial], param: str) -> bool:
    for t in trials:
        if param in t.distributions:
            return bool(getattr(t.distributions[param], "log", False))
    return False


def _is_categorical(trials: list[FrozenTrial], param: str) -> bool:
    for t in trials:
        if param in t.distributions:
            return isinstance(t.distributions[param], CategoricalDistribution)
    return False


def _is_numerical(trials: list[FrozenTrial], param: str) -> bool:
    return all(
        isinstance(t.params[param], (int, float)) and not isinstance(t.params[param], bool)
        for t in trials
        if param in t.params
    )


def _feasible(trial: FrozenTrial) -> bool:
    from optuna_tpu_torch.study._constrained_optimization import _is_feasible

    return _is_feasible(trial.system_attrs)


# ------------------------------------------------------- optimization history


@dataclass
class HistorySeries:
    study_name: str
    trial_numbers: list[int]
    values: list[float]
    best_values: list[float] | None  # None when target overrides the objective
    # error-bar mode only:
    stdev: list[float] | None = None


def resolve_target_name(studies: Sequence[Any], target: Callable | None, target_name: str) -> str:
    """:meth:`Study.set_metric_names` overrides the default label when the
    raw objective is plotted (reference ``_optimization_history.py:107``)."""
    if target is None and studies and getattr(studies[0], "metric_names", None):
        return studies[0].metric_names[0]
    return target_name


def optimization_history_data(
    studies: Sequence[Any],
    target: Callable | None,
    target_name: str,
    error_bar: bool,
) -> list[HistorySeries]:
    """One series per study; with ``error_bar`` the studies are aggregated
    into a single mean +/- stdev series keyed by trial number (reference
    ``_optimization_history.py:32-103``)."""
    series: list[HistorySeries] = []
    for study in studies:
        trials = _completed(study)
        numbers = [t.number for t in trials]
        values = [_value_of(t, target) for t in trials]
        best = None
        if target is None and not study._is_multi_objective() and values:
            acc = (
                np.minimum.accumulate(values)
                if study.direction == StudyDirection.MINIMIZE
                else np.maximum.accumulate(values)
            )
            best = [float(v) for v in acc]
        series.append(HistorySeries(study.study_name, numbers, values, best))
    if not error_bar:
        return series

    # Aggregate across studies: mean/stdev of value and best at each number
    # present in every study (the reference intersects trial numbers).
    common = None
    for s in series:
        nums = set(s.trial_numbers)
        common = nums if common is None else (common & nums)
    common = sorted(common or set())
    by_num = []
    for s in series:
        idx = {n: i for i, n in enumerate(s.trial_numbers)}
        by_num.append(idx)
    mean_vals, std_vals, mean_best = [], [], []
    for n in common:
        vs = [s.values[by_num[i][n]] for i, s in enumerate(series)]
        mean_vals.append(float(np.mean(vs)))
        std_vals.append(float(np.std(vs)))
        if all(s.best_values is not None for s in series):
            bs = [s.best_values[by_num[i][n]] for i, s in enumerate(series)]
            mean_best.append(float(np.mean(bs)))
    return [
        HistorySeries(
            study_name="error-bar",
            trial_numbers=common,
            values=mean_vals,
            best_values=mean_best if mean_best else None,
            stdev=std_vals,
        )
    ]


# ---------------------------------------------------------------------- slice


@dataclass
class SliceSubplot:
    param: str
    x: list  # numerical values or category labels
    y: list[float]
    trial_numbers: list[int]
    is_log: bool
    is_categorical: bool
    # Categorical display order + per-trial index into it, shared by both
    # backends so category ordering cannot drift between them.
    labels: list[str] = field(default_factory=list)
    x_indices: list[int] = field(default_factory=list)


def _categorical_mapping(values: list) -> tuple[list[str], list[int]]:
    labels = sorted({str(v) for v in values})
    return labels, [labels.index(str(v)) for v in values]


def slice_data(
    study, params: list[str] | None, target: Callable | None
) -> list[SliceSubplot]:
    trials = _completed(study)
    names = params if params is not None else _intersection_params(trials)
    out = []
    for p in names:
        sub = [t for t in trials if p in t.params]
        xs = [t.params[p] for t in sub]
        is_cat = _is_categorical(sub, p)
        labels, idx = _categorical_mapping(xs) if is_cat else ([], [])
        out.append(
            SliceSubplot(
                param=p,
                x=xs,
                y=[_value_of(t, target) for t in sub],
                trial_numbers=[t.number for t in sub],
                is_log=_is_log(sub, p),
                is_categorical=is_cat,
                labels=labels,
                x_indices=idx,
            )
        )
    return out


# -------------------------------------------------------------------- contour


@dataclass
class ContourAxis:
    param: str
    is_log: bool
    is_categorical: bool
    range: tuple[float, float]
    # categorical axes list their labels in display order:
    labels: list[str] = field(default_factory=list)


@dataclass
class ContourPair:
    x: ContourAxis
    y: ContourAxis
    x_points: list[float]  # observed points (mapped: log10 kept linear here)
    y_points: list[float]
    z_points: list[float]
    grid_x: np.ndarray  # (CONTOUR_POINTS,)
    grid_y: np.ndarray
    grid_z: np.ndarray  # (CONTOUR_POINTS, CONTOUR_POINTS), NaN where no data


def _axis_info(trials: list[FrozenTrial], param: str) -> ContourAxis:
    is_cat = _is_categorical(trials, param)
    is_log = _is_log(trials, param)
    vals = [t.params[param] for t in trials if param in t.params]
    if is_cat or not _is_numerical(trials, param):
        labels = sorted({str(v) for v in vals})
        return ContourAxis(param, False, True, (-0.5, len(labels) - 0.5), labels)
    nums = np.asarray([float(v) for v in vals], dtype=np.float64)
    lo, hi = float(np.min(nums)), float(np.max(nums))
    if is_log:
        lo, hi = math.log10(max(lo, 1e-300)), math.log10(max(hi, 1e-300))
    pad = (hi - lo) * PADDING_RATIO or 0.5
    return ContourAxis(param, is_log, False, (lo - pad, hi + pad))


def _axis_coord(axis: ContourAxis, value) -> float:
    if axis.is_categorical:
        return float(axis.labels.index(str(value)))
    v = float(value)
    return math.log10(max(v, 1e-300)) if axis.is_log else v


def _interpolate_grid(
    xs: np.ndarray, ys: np.ndarray, zs: np.ndarray, gx: np.ndarray, gy: np.ndarray
) -> np.ndarray:
    """Nearest-neighbour fill over a linear-interpolation base, mirroring the
    reference's plotly ``connectgaps``-like behavior without SciPy's Qhull
    dependency being mandatory."""
    def nearest_only() -> np.ndarray:
        # Degenerate geometry (collinear points, too few trials): nearest only.
        gz = np.empty((len(gy), len(gx)))
        for i, yv in enumerate(gy):
            for j, xv in enumerate(gx):
                k = int(np.argmin((xs - xv) ** 2 + (ys - yv) ** 2))
                gz[i, j] = zs[k]
        return gz

    try:
        from scipy.interpolate import griddata

        try:
            from scipy.spatial import QhullError
        except ImportError:  # scipy < 1.8 keeps it in the private module
            from scipy.spatial.qhull import QhullError
    except ImportError:  # SciPy is optional for visualization
        return nearest_only()
    try:
        pts = np.stack([xs, ys], axis=1)
        grid = griddata(pts, zs, (gx[None, :], gy[:, None]), method="linear")
        near = griddata(pts, zs, (gx[None, :], gy[:, None]), method="nearest")
        return np.where(np.isnan(grid), near, grid)
    except (QhullError, ValueError):
        return nearest_only()


def contour_pair_data(
    study, px: str, py: str, target: Callable | None
) -> ContourPair:
    trials = _completed(study)
    sub = [t for t in trials if px in t.params and py in t.params]
    ax_x = _axis_info(sub, px)
    ax_y = _axis_info(sub, py)
    xs = np.asarray([_axis_coord(ax_x, t.params[px]) for t in sub])
    ys = np.asarray([_axis_coord(ax_y, t.params[py]) for t in sub])
    zs = np.asarray([_value_of(t, target) for t in sub], dtype=np.float64)
    gx = np.linspace(ax_x.range[0], ax_x.range[1], CONTOUR_POINTS)
    gy = np.linspace(ax_y.range[0], ax_y.range[1], CONTOUR_POINTS)
    if len(sub) >= 3 and len(set(zip(xs.tolist(), ys.tolist()))) >= 3:
        gz = _interpolate_grid(xs, ys, zs, gx, gy)
    else:
        gz = np.full((CONTOUR_POINTS, CONTOUR_POINTS), np.nan)
    return ContourPair(
        x=ax_x, y=ax_y,
        x_points=xs.tolist(), y_points=ys.tolist(), z_points=zs.tolist(),
        grid_x=gx, grid_y=gy, grid_z=gz,
    )


def contour_data(
    study, params: list[str] | None, target: Callable | None
) -> list[list[ContourPair | None]]:
    """The full param-pair matrix (diagonal = None), like the reference's
    subplot grid; a single off-diagonal cell for exactly two params."""
    trials = _completed(study)
    names = params if params is not None else _intersection_params(trials)
    if len(set(names)) < 2:
        raise ValueError("plot_contour needs at least two distinct parameters.")
    names = list(dict.fromkeys(names))
    k = len(names)
    matrix: list[list[ContourPair | None]] = [[None] * k for _ in range(k)]
    for r in range(k):
        for c in range(r + 1, k):
            # Cell (r, c): x = names[c], y = names[r]; its mirror is the
            # same surface transposed — no second interpolation pass.
            pair = contour_pair_data(study, names[c], names[r], target)
            matrix[r][c] = pair
            matrix[c][r] = ContourPair(
                x=pair.y, y=pair.x,
                x_points=pair.y_points, y_points=pair.x_points,
                z_points=pair.z_points,
                grid_x=pair.grid_y, grid_y=pair.grid_x,
                grid_z=pair.grid_z.T,
            )
    return matrix


# -------------------------------------------------------- parallel coordinate


@dataclass
class ParallelAxis:
    label: str
    values: list[float]  # per-trial coordinate on this axis
    range: tuple[float, float]
    is_log: bool = False
    is_categorical: bool = False
    tick_values: list[float] = field(default_factory=list)
    tick_labels: list[str] = field(default_factory=list)


def parallel_coordinate_data(
    study, params: list[str] | None, target: Callable | None, target_name: str
) -> tuple[list[ParallelAxis], list[float]]:
    """Axes (objective first) + the per-trial color values (= objective)."""
    trials = _completed(study)
    names = params if params is not None else _intersection_params(trials)
    trials = [t for t in trials if all(p in t.params for p in names)]
    obj = [_value_of(t, target) for t in trials]
    axes = [
        ParallelAxis(
            label=target_name,
            values=list(obj),
            range=(min(obj, default=0.0), max(obj, default=1.0)),
        )
    ]
    for p in names:
        if _is_categorical(trials, p) or not _is_numerical(trials, p):
            labels = sorted({str(t.params[p]) for t in trials})
            vals = [float(labels.index(str(t.params[p]))) for t in trials]
            axes.append(
                ParallelAxis(
                    label=p, values=vals,
                    range=(0.0, float(max(len(labels) - 1, 1))),
                    is_categorical=True,
                    tick_values=[float(i) for i in range(len(labels))],
                    tick_labels=labels,
                )
            )
        else:
            is_log = _is_log(trials, p)
            raw = [float(t.params[p]) for t in trials]
            vals = [math.log10(max(v, 1e-300)) for v in raw] if is_log else raw
            lo, hi = (min(vals), max(vals)) if vals else (0.0, 1.0)
            ticks: list[float] = []
            tick_labels: list[str] = []
            if is_log:
                for e in range(math.floor(lo), math.ceil(hi) + 1):
                    ticks.append(float(e))
                    tick_labels.append(f"1e{e}")
            axes.append(
                ParallelAxis(
                    label=p, values=vals, range=(lo, hi), is_log=is_log,
                    tick_values=ticks, tick_labels=tick_labels,
                )
            )
    return axes, obj


# ----------------------------------------------------------------------- rank


@dataclass
class RankSubplot:
    param: str
    x: list
    y: list[float]  # raw objective values
    colors: list[float]  # normalized rank in [0, 1]
    trial_numbers: list[int]
    is_log: bool
    is_categorical: bool
    labels: list[str] = field(default_factory=list)
    x_indices: list[int] = field(default_factory=list)


def rank_data(
    study, params: list[str] | None, target: Callable | None
) -> list[RankSubplot]:
    from scipy.stats import rankdata

    trials = _completed(study)
    names = params if params is not None else _intersection_params(trials)
    values = np.asarray([_value_of(t, target) for t in trials], dtype=np.float64)
    if target is None and study.direction == StudyDirection.MAXIMIZE:
        ranks = rankdata(-values)
    else:
        ranks = rankdata(values)
    norm = (ranks - 1) / max(len(trials) - 1, 1)
    out = []
    for p in names:
        mask = np.asarray([p in t.params for t in trials])
        sub = [t for t, m in zip(trials, mask) if m]
        xs = [t.params[p] for t in sub]
        is_cat = _is_categorical(sub, p)
        labels, idx = _categorical_mapping(xs) if is_cat else ([], [])
        out.append(
            RankSubplot(
                param=p,
                x=xs,
                y=[float(v) for v in values[mask]],
                colors=[float(c) for c in norm[mask]],
                trial_numbers=[t.number for t in sub],
                is_log=_is_log(sub, p),
                is_categorical=is_cat,
                labels=labels,
                x_indices=idx,
            )
        )
    return out


# ------------------------------------------------------------------------ edf


@dataclass
class EdfSeries:
    study_name: str
    x: np.ndarray
    y: np.ndarray


def edf_data(
    studies: Sequence[Any], target: Callable | None, n_grid: int = 100
) -> list[EdfSeries]:
    """All studies share one x-grid spanning the union of value ranges
    (reference ``_edf.py:75-103``) so the curves are comparable."""
    all_values = []
    per_study = []
    for s in studies:
        vals = np.asarray([_value_of(t, target) for t in _completed(s)], dtype=np.float64)
        per_study.append((s.study_name, vals))
        if len(vals):
            all_values.append(vals)
    if not all_values:
        return []
    lo = min(float(v.min()) for v in all_values)
    hi = max(float(v.max()) for v in all_values)
    grid = np.linspace(lo, hi, n_grid)
    out = []
    for name, vals in per_study:
        if not len(vals):
            continue
        y = np.searchsorted(np.sort(vals), grid, side="right") / len(vals)
        out.append(EdfSeries(name, grid, y))
    return out


# --------------------------------------------------------------- pareto front


@dataclass
class ParetoFrontData:
    n_objectives: int
    target_names: list[str]
    best_values: list[list[float]]
    best_numbers: list[int]
    other_values: list[list[float]]
    other_numbers: list[int]
    infeasible_values: list[list[float]]
    infeasible_numbers: list[int]
    # Axis permutation (reference ``_pareto_front.py`` ``axis_order``):
    # axes[i] renders values[axis_order[i]].
    axis_order: list[int] = field(default_factory=list)


def pareto_front_data(
    study,
    target_names: list[str] | None,
    include_dominated_trials: bool,
    targets: Callable | None = None,
    axis_order: list[int] | None = None,
    constraints_func: Callable | None = None,
) -> ParetoFrontData:
    n_obj = len(study.directions)
    if targets is None and n_obj not in (2, 3):
        raise ValueError("plot_pareto_front works with 2 or 3 objectives.")
    if targets is not None and axis_order is not None:
        raise ValueError(
            "Using both `targets` and `axis_order` is forbidden; "
            "reorder the axes inside `targets` instead."
        )
    if targets is not None and target_names is None:
        # The projection can change the axis count, so default per-objective
        # names cannot label it (reference ``_pareto_front.py`` info builder).
        raise ValueError("If `targets` is specified, `target_names` must be specified too.")
    trials = _completed(study)
    if constraints_func is not None:
        # Plot-time feasibility override (reference's deprecated-but-supported
        # ``constraints_func``): evaluate constraints on each frozen trial
        # instead of reading the sampler-recorded system attrs, and recompute
        # the front over the feasible subset (a study-front trial the
        # override marks infeasible must yield its place to the trials it
        # dominated).
        def ok(t: FrozenTrial) -> bool:
            try:
                return all(float(c) <= 0.0 for c in constraints_func(t))
            except Exception:  # graphlint: ignore[PY001] -- user callback isolation: any crash in constraints_func means "infeasible", never a broken plot
                return False

        feasible = [t for t in trials if ok(t)]
        infeasible = [t for t in trials if not ok(t)]
        front_trials = _get_pareto_front_trials_by_trials(feasible, study.directions)
    else:
        feasible = [t for t in trials if _feasible(t)]
        infeasible = [t for t in trials if not _feasible(t)]
        front_trials = _get_pareto_front_trials(study, consider_constraint=True)

    def vals(t: FrozenTrial) -> list[float]:
        if targets is not None:
            out = targets(t)
            return [float(v) for v in (out if isinstance(out, (list, tuple)) else [out])]
        return [float(v) for v in t.values]

    front = {t.number for t in front_trials}
    best = [t for t in feasible if t.number in front]
    other = [t for t in feasible if t.number not in front] if include_dominated_trials else []
    names = target_names or (
        study.metric_names or [f"Objective {i}" for i in range(n_obj)]
    )
    sample = (
        [vals(t) for t in best[:1]] or [vals(t) for t in other[:1]]
        or [vals(t) for t in infeasible[:1]]
    )
    n_axes = len(sample[0]) if sample else n_obj
    if axis_order is None:
        order = list(range(n_axes))
    else:
        order = [int(i) for i in axis_order]
        if sorted(order) != list(range(n_axes)):
            raise ValueError(
                f"axis_order must be a permutation of 0..{n_axes - 1}, got {axis_order}."
            )
    return ParetoFrontData(
        n_objectives=n_obj,
        target_names=list(names),
        best_values=[vals(t) for t in best],
        best_numbers=[t.number for t in best],
        other_values=[vals(t) for t in other],
        other_numbers=[t.number for t in other],
        infeasible_values=[vals(t) for t in infeasible],
        infeasible_numbers=[t.number for t in infeasible],
        axis_order=order,
    )


# ------------------------------------------------------------ importances


def importances_data(
    study,
    evaluator,
    params: list[str] | None,
    target: Callable | None,
    target_name: str,
    device=None,
) -> list[tuple[str, dict[str, float]]]:
    """(target_name, importances) per objective (reference
    ``_param_importances.py:83-110``): a multi-objective study with no
    ``target`` yields one entry per objective, and
    :meth:`Study.set_metric_names` overrides ``target_name``. With no
    ``evaluator`` the default fANOVA's forest grows on ``device``."""
    from optuna_tpu_torch.importance import FanovaImportanceEvaluator, get_param_importances

    if evaluator is None:
        evaluator = FanovaImportanceEvaluator(device=device)

    metric_names = study.metric_names
    if target is not None or not study._is_multi_objective():
        if target is None and metric_names:
            target_name = metric_names[0]
        return [
            (
                target_name,
                get_param_importances(
                    study, evaluator=evaluator, params=params, target=target
                ),
            )
        ]
    n_obj = len(study.directions)
    names = metric_names or [f"Objective {i}" for i in range(n_obj)]
    return [
        (
            names[i],
            get_param_importances(
                study, evaluator=evaluator, params=params,
                target=(lambda t, i=i: t.values[i]),
            ),
        )
        for i in range(n_obj)
    ]


def is_reverse_scale(study, target: Callable | None) -> bool:
    """Colormap direction (reference ``_utils.py:169``): reversed when a
    custom target is plotted or the objective is minimized, so 'better' is
    always the darker end."""
    return target is not None or study.direction == StudyDirection.MINIMIZE


# ------------------------------------------------------------------- timeline


@dataclass
class TimelineBar:
    number: int
    start: datetime.datetime
    complete: datetime.datetime
    state: TrialState
    hover: str


def timeline_data(study) -> list[TimelineBar]:
    bars = []
    now = datetime.datetime.now()
    for t in study.get_trials(deepcopy=False):
        if t.datetime_start is None:
            continue
        complete = t.datetime_complete or now
        bars.append(
            TimelineBar(
                number=t.number,
                start=t.datetime_start,
                complete=max(complete, t.datetime_start),
                state=t.state,
                hover=f"Trial {t.number}<br>state: {t.state.name}<br>params: {t.params}",
            )
        )
    return bars


# ------------------------------------------------------- intermediate values


@dataclass
class IntermediateSeries:
    trial_number: int
    steps: list[int]
    values: list[float]
    state: TrialState


def intermediate_values_data(study) -> list[IntermediateSeries]:
    out = []
    for t in study.get_trials(deepcopy=False):
        if not t.intermediate_values:
            continue
        steps, vals = zip(*sorted(t.intermediate_values.items()))
        out.append(
            IntermediateSeries(t.number, list(steps), [float(v) for v in vals], t.state)
        )
    return out
