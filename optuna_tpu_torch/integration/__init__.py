"""Integration shims (reference ``optuna/integration/__init__.py``).

The reference forwards 25 integration modules to the external
``optuna-integration`` distribution; this build does the same — names
resolve lazily and raise a pointed ImportError when the companion package
is absent.
"""

from __future__ import annotations

_INTEGRATIONS = [
    "BoTorchSampler",
    "CatBoostPruningCallback",
    "DaskStorage",
    "FastAIPruningCallback",
    "KerasPruningCallback",
    "LightGBMPruningCallback",
    "LightGBMTuner",
    "MLflowCallback",
    "OptunaSearchCV",
    "PyTorchIgnitePruningHandler",
    "PyTorchLightningPruningCallback",
    "SkoptSampler",
    "TensorBoardCallback",
    "TFKerasPruningCallback",
    "WeightsAndBiasesCallback",
    "XGBoostPruningCallback",
]

__all__ = list(_INTEGRATIONS)


def __getattr__(name: str):
    if name in _INTEGRATIONS:
        raise ImportError(
            f"optuna_tpu_torch.integration.{name} requires the separate "
            "`optuna-tpu-integration` package, which is not installed in this "
            "environment."
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
