"""Quasi-Monte-Carlo sequences (host tier of ``optuna_tpu/ops/qmc.py``):
SciPy's scrambled Sobol and Halton engines, and standard-normal QMC draws.

The reference's GP pool is its device Sobol, digitally shifted by a
``jax.random`` key; that stream cannot be reproduced in PyTorch. The port
uses the reference's own fallback instead: SciPy's scrambled Sobol on the
host, uploaded once per search space. Only engine *construction* is
serialized (SciPy lazily fills module-global tables on first use);
generation on independent engines runs lock-free.
"""

from __future__ import annotations

import threading

import numpy as np

_sobol_init_lock = threading.Lock()  # guards SciPy's lazy direction-table init
_tables_ready: set[str] = set()  # engine kinds whose lazy init has completed


def _make_engine(kind: str, dim: int, seed: int | None):
    """Construct a SciPy QMC engine; the first-ever construction of a kind is
    locked while SciPy fills its module-level tables, later ones are
    thread-safe."""
    from scipy.stats import qmc

    cls = qmc.Sobol if kind == "sobol" else qmc.Halton
    kwargs = {"d": dim, "scramble": True, "seed": seed}
    if kind not in _tables_ready:
        with _sobol_init_lock:
            engine = cls(**kwargs)
            _tables_ready.add(kind)
            return engine
    return cls(**kwargs)


def sobol_sample(n: int, dim: int, seed: int | None = None) -> np.ndarray:
    """n scrambled-Sobol points in [0, 1)^dim (n need not be a power of two)."""
    engine = _make_engine("sobol", dim, seed)
    # Sobol balance prefers powers of two; round up then truncate.
    m = int(np.ceil(np.log2(max(n, 1))))
    pts = engine.random_base2(m=m) if n > 1 else engine.random(1)
    return pts[:n]


def halton_sample(n: int, dim: int, seed: int | None = None) -> np.ndarray:
    """n scrambled-Halton points in [0, 1)^dim."""
    return _make_engine("halton", dim, seed).random(n)


def normal_qmc_sample(n: int, dim: int, seed: int | None = None) -> np.ndarray:
    """Standard-normal QMC draws via Sobol + inverse CDF (reference qmc.py:18)."""
    from scipy.special import ndtri

    u = sobol_sample(n, dim, seed)
    # Keep strictly inside (0, 1) so ndtri stays finite.
    eps = np.finfo(np.float64).eps
    return ndtri(np.clip(u, eps, 1 - eps))
