"""Deadline watchdog (port of the deadline half of
``optuna_tpu/parallel/executor.py``).

:func:`run_with_deadline` runs a call on a daemon thread and raises
:class:`DispatchTimeoutError` when it overruns its deadline on an
injectable clock; ``GuardedSampler``'s fit deadline uses it. The resilient
batch executor around it in the reference (quarantine, bisection, OOM
halving, ``optimize_vectorized``) waits for ROADMAP A7.

On the card, an abandoned call keeps launching kernels from its thread
while the caller goes on, as the reference's keeps dispatching to the TPU:
the semantics are the same, and the contention is not measured.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from optuna_tpu_torch.exceptions import OptunaTPUError


class DispatchTimeoutError(OptunaTPUError, TimeoutError):
    """A device dispatch overran ``dispatch_deadline_s`` and was abandoned."""


def run_with_deadline(
    fn: Callable[[], "object"],
    deadline_s: float,
    clock: Callable[[], float] = time.monotonic,
    *,
    describe: str = "device dispatch",
    thread_name: str = "optuna-tpu-dispatch",
) -> "object":
    """Run ``fn`` on a watchdog thread; raise :class:`DispatchTimeoutError`
    when it overruns ``deadline_s`` (measured on the injectable ``clock``).

    The hung thread is abandoned (daemon) and its eventual result, if any,
    discarded — the caller takes its failure path. The sampler resilience
    layer's fit watchdog (:mod:`optuna_tpu_torch.samplers._resilience`)
    uses it so that a hang becomes a contained failure, not a stuck study.
    """
    box: list = []
    failure: list[BaseException] = []

    def _target() -> None:
        try:
            box.append(fn())
        except BaseException as err:  # thread trampoline: the error is re-raised verbatim on the dispatching thread below, nothing is swallowed
            failure.append(err)

    worker = threading.Thread(target=_target, name=thread_name, daemon=True)
    start = clock()
    worker.start()
    while worker.is_alive():
        remaining = deadline_s - (clock() - start)
        if remaining <= 0:
            break
        worker.join(timeout=min(0.05, remaining))
    if worker.is_alive():
        raise DispatchTimeoutError(
            f"{describe} exceeded the {deadline_s}s deadline"
        )
    if failure:
        raise failure[0]
    return box[0]
