"""Cross-cutting infra (port of ``optuna_tpu/utils``; reference
``optuna/_imports.py``, ``_experimental.py``, ``_deprecated.py``,
``_convert_positional_args.py``).

The API-lifecycle decorators and the deferred imports; ``_compile_cache``
sets where the CUDA kernels' libraries are built."""

from optuna_tpu_torch.utils._compat import (
    convert_positional_args,
    deprecated_class,
    deprecated_func,
    experimental_class,
    experimental_func,
)
from optuna_tpu_torch.utils._imports import _LazyImport, try_import

__all__ = [
    "_LazyImport",
    "convert_positional_args",
    "deprecated_class",
    "deprecated_func",
    "experimental_class",
    "experimental_func",
    "try_import",
]
