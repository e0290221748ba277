"""The check that a run loaded neither JAX nor the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole word, so ``optuna_tpu_torch`` is not taken for
``optuna_tpu``.
"""

from __future__ import annotations

from typing import Iterable

FORBIDDEN = ("jax", "jaxlib", "flax", "optuna_tpu")


def forbidden_modules(names: Iterable[str]) -> list[str]:
    """The sorted top-level names among ``names`` that are forbidden."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
