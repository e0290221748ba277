"""Latency-aware placement for small, launch-bound work (port of
``optuna_tpu/_device_policy.py``).

Heavy programs amortize a device round trip easily, but a tiny kernel whose
host arithmetic takes tens of microseconds loses when every call pays a
long trip to the card and back (a card behind a remote tunnel, say). The
policy: measure the card's full round trip once per process — fresh host
data in, a trivial op, the result back on the host, best of 3 — and route
small work to the CPU only when that trip exceeds 2 ms (the reference's
threshold). On a directly attached card, such as an H100 on its host, the
card is kept.

A device the caller passes is never overridden: the policy only fills in
``device=None``.
"""

from __future__ import annotations

import functools
import time

import torch

from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.logging import get_logger

_logger = get_logger(__name__)

_LATENCY_THRESHOLD_S = 2e-3


@functools.lru_cache(maxsize=None)
def default_dispatch_latency_s() -> float:
    """The card's best-of-3 full cycle: fresh host data in, a trivial op,
    the result back on the host (the first cycle, which initializes CUDA,
    is not counted). Fresh data each time, so no cache can answer a repeat
    transfer."""
    device = resolve_device(None)

    def once() -> float:
        x = torch.rand(8)
        t0 = time.perf_counter()
        (x.to(device) * 2.0 + 1.0).cpu()
        return time.perf_counter() - t0

    once()
    return min(once() for _ in range(3))


@functools.lru_cache(maxsize=None)
def _routed_device() -> torch.device:
    latency = default_dispatch_latency_s()
    if latency < _LATENCY_THRESHOLD_S:
        device = resolve_device(None)
    else:
        device = torch.device("cpu")
    _logger.info(
        f"small kernels run on {device}: the card's round trip is {latency * 1e3:.3f} ms "
        f"(the CPU is taken above {_LATENCY_THRESHOLD_S * 1e3:g} ms)"
    )
    return device


def small_kernel_device(device: "str | torch.device | None" = None) -> torch.device:
    """Where small, launch-bound work runs: ``device`` itself when the caller
    passed one; otherwise the card, or the CPU when the card's round trip
    exceeds 2 ms. The measurement and its log line happen once per
    process. With no GPU and no ``device`` it raises, as
    :func:`~optuna_tpu_torch._device.resolve_device` does."""
    if device is not None:
        return resolve_device(device)
    return _routed_device()
