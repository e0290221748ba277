"""Quasi-Monte-Carlo sequences (port of ``optuna_tpu/ops/qmc.py``). Two tiers:

* **Host tier** (``sobol_sample`` / ``halton_sample`` /
  ``normal_qmc_sample``): SciPy's scrambled engines. Only engine
  *construction* is serialized (SciPy lazily fills module-global tables on
  first use); generation on independent engines runs lock-free. The port's
  GP sampler draws its candidate pool here, uploaded once per search space.
* **Device tier** (``sobol_sample_device``): the direction numbers are
  taken once per dimension on the host, and the points are made on the
  card by a Gray-code XOR pipeline in int64 with an optional digital
  shift. The pipeline is exact integer arithmetic, so with no shift it is
  SciPy's ``scramble=False`` stream bit for bit, and given one shift vector
  it equals the reference's. The shift comes from a ``torch.Generator``
  where the reference takes a ``jax.random`` key.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device

_sobol_init_lock = threading.Lock()  # guards SciPy's lazy direction-table init
_tables_ready: set[str] = set()  # engine kinds whose lazy init has completed

_MAXBIT = 30  # SciPy direction numbers are scaled to 2^30
_direction_cache: dict[int, np.ndarray] = {}


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


# ------------------------------------------------------------- device tier


def _direction_numbers(dim: int) -> np.ndarray:
    """(dim, 30) uint32 Sobol direction vectors (Joe-Kuo via SciPy), cached."""
    cached = _direction_cache.get(dim)
    if cached is None:
        from scipy.stats import qmc

        with _sobol_init_lock:
            cached = np.ascontiguousarray(
                qmc.Sobol(d=dim, scramble=False)._sv[:, :_MAXBIT].astype(np.uint32)
            )
        _direction_cache[dim] = cached
    return cached


def _sobol_device_kernel(sv: torch.Tensor, shift: torch.Tensor, n: int) -> torch.Tensor:
    """(n, dim) float32 Sobol points from (dim, 30) int64 direction numbers
    and a (dim,) int64 digital shift, on ``sv``'s device. Every value fits in
    30 bits, so int64 holds the reference's uint32 arithmetic exactly."""
    i = torch.arange(n, dtype=torch.int64, device=sv.device)
    gray = i ^ (i >> 1)
    acc = torch.zeros((n, sv.shape[0]), dtype=torch.int64, device=sv.device)
    for b in range(_MAXBIT):
        bit = (gray >> b) & 1
        acc = acc ^ (bit[:, None] * sv[None, :, b])
    acc = acc ^ shift[None, :]
    return acc.to(torch.float32) * (2.0**-_MAXBIT)


def sobol_sample_device(
    n: int,
    dim: int,
    generator: torch.Generator | None = None,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """n Sobol points in [0, 1)^dim generated on the card, (n, dim) float32.

    ``generator`` applies a digital-shift scramble, drawn as
    ``torch.randint(0, 2**30, (dim,), generator=generator)`` on the
    generator's own device; None yields the raw sequence (first point at
    the origin), matching SciPy's ``scramble=False`` stream bit for bit.
    ``device=None`` is the card; the CPU is used only when asked for.
    """
    dev = resolve_device(device)
    sv = torch.as_tensor(_direction_numbers(dim).astype(np.int64), device=dev)
    if generator is None:
        shift = torch.zeros((dim,), dtype=torch.int64, device=dev)
    else:
        shift = torch.randint(
            0, 1 << _MAXBIT, (dim,), generator=generator,
            dtype=torch.int64, device=generator.device,
        ).to(dev)
    return _sobol_device_kernel(sv, shift, n)
