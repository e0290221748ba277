"""Search-space helpers (reference ``optuna_tpu/search_space/__init__.py``)."""

from optuna_tpu_torch.search_space.intersection import (
    IntersectionSearchSpace,
    intersection_search_space,
)

__all__ = ["IntersectionSearchSpace", "intersection_search_space"]
