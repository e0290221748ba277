"""Where the CUDA kernels' libraries are built (port of
``optuna_tpu/utils/_compile_cache.py``).

The port's kernels are built by ``nvcc`` at first use into a library cache
keyed by a hash of each source and its flags
(:mod:`optuna_tpu_torch.ops.kernels._nvcc`), by default the git-ignored
``optuna_tpu_torch/ops/kernels/_build/`` beside the sources.
:func:`ensure_compile_cache`, called when the package is imported, points
that cache elsewhere on request:

* ``OPTUNA_TPU_TORCH_CACHE_DIR=<dir>`` — build into ``<dir>`` (shared by
  every checkout on the machine, so a second checkout starts warm);
* ``OPTUNA_TPU_TORCH_NO_COMPILE_CACHE=1`` — build into a fresh temporary
  directory, so nothing built earlier is reused.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

_done = False


def ensure_compile_cache() -> None:
    """Idempotently set the kernels' build directory from the environment."""
    global _done
    if _done:
        return
    _done = True
    from optuna_tpu_torch.ops.kernels import _nvcc

    if os.environ.get("OPTUNA_TPU_TORCH_NO_COMPILE_CACHE"):
        _nvcc.BUILD_DIR = Path(tempfile.mkdtemp(prefix="optuna_tpu_torch_kernels_"))
        return
    cache_dir = os.environ.get("OPTUNA_TPU_TORCH_CACHE_DIR")
    if cache_dir:
        _nvcc.BUILD_DIR = Path(cache_dir).expanduser()
