"""Quasi-Monte-Carlo points for the acquisition candidate pool (host tier of
``optuna_tpu/ops/qmc.py``).

The reference's GP pool is its device Sobol, digitally shifted by a
``jax.random`` key; that stream cannot be reproduced in PyTorch. The port
uses the reference's own fallback instead: SciPy's scrambled Sobol on the
host, uploaded once per search space.
"""

from __future__ import annotations

import threading

import numpy as np

_sobol_init_lock = threading.Lock()  # guards SciPy's lazy direction-table init
_tables_ready = False


def _make_engine(dim: int, seed: int | None):
    """Construct a SciPy Sobol engine; the first-ever construction is locked
    while SciPy fills its module-level tables, later ones are thread-safe."""
    global _tables_ready
    from scipy.stats import qmc

    if not _tables_ready:
        with _sobol_init_lock:
            engine = qmc.Sobol(d=dim, scramble=True, seed=seed)
            _tables_ready = True
            return engine
    return qmc.Sobol(d=dim, scramble=True, seed=seed)


def sobol_sample(n: int, dim: int, seed: int | None = None) -> np.ndarray:
    """n scrambled-Sobol points in [0, 1)^dim (n need not be a power of two)."""
    engine = _make_engine(dim, seed)
    # Sobol balance prefers powers of two; round up then truncate.
    m = int(np.ceil(np.log2(max(n, 1))))
    pts = engine.random_base2(m=m) if n > 1 else engine.random(1)
    return pts[:n]
