"""Search-space helpers (reference ``optuna_tpu/search_space/__init__.py``)."""

from optuna_tpu_torch.search_space.group_decomposed import _GroupDecomposedSearchSpace
from optuna_tpu_torch.search_space.intersection import (
    IntersectionSearchSpace,
    intersection_search_space,
)

__all__ = [
    "IntersectionSearchSpace",
    "_GroupDecomposedSearchSpace",
    "intersection_search_space",
]
