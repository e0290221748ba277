"""Matplotlib plots (reference ``optuna/visualization/matplotlib/``)."""

from optuna_tpu_torch.visualization.matplotlib._plots import (
    plot_contour,
    plot_edf,
    plot_hypervolume_history,
    plot_intermediate_values,
    plot_optimization_history,
    plot_parallel_coordinate,
    plot_param_importances,
    plot_pareto_front,
    plot_rank,
    plot_slice,
    plot_terminator_improvement,
    plot_timeline,
)

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
]


def is_available() -> bool:
    """Whether the matplotlib backend can render (reference
    ``optuna/visualization/matplotlib/__init__.py:13-17``)."""
    try:
        import matplotlib  # noqa: F401

        return True
    except ImportError:
        return False
