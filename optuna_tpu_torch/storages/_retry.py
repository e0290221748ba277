"""Resilient storage RPC layer: retry policy + transparent retrying wrapper
(port of ``optuna_tpu/storages/_retry.py``).

Asynchronous distributed HPO makes transient storage failures the common
case, not the exception (Dorier et al., arXiv:2210.00798): a proxy server
restarts mid-study, an NFS lock takes two extra seconds, a connection pool
hands back a dead socket. This module centralizes the retry discipline every
layer shares:

* :class:`RetryPolicy` — exponential backoff with **full jitter** (each delay
  is uniform in ``[0, cap]``, the AWS-recommended variant that decorrelates
  retry storms), a bounded attempt count, and an overall deadline. The
  clock/sleep/rng are injectable so tests assert the schedule without real
  waiting.
* :class:`RetryingStorage` — wraps any :class:`BaseStorage` and replays
  transiently-failed calls. Non-idempotent creates are NOT retried unless the
  caller vouches for safety (see the class docstring).
* :class:`TransientStorageError` — the marker type backends and fault
  injectors raise for retry-safe faults.

The journal file locks reuse the same jittered-backoff schedule for lock
acquisition, and the gRPC proxy
(:class:`~optuna_tpu_torch.storages._grpc.client.GrpcStorageProxy`) replays
its transport failures under a :class:`RetryPolicy` too.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Sequence

from optuna_tpu_torch import telemetry
from optuna_tpu_torch.exceptions import StorageInternalError
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages._base import BaseStorage, _ForwardingStorage

_logger = get_logger(__name__)


class TransientStorageError(StorageInternalError):
    """A storage fault that is safe to retry.

    Raised for failures that strike *before* the backend committed anything
    (connection refused, lock-acquisition timeout, injected chaos), so a
    replay cannot double-apply a write.
    """


#: Exception types retried by default. ``ConnectionError`` covers the socket
#: family (ConnectionResetError, BrokenPipeError, ...); ``TimeoutError``
#: covers both the OS and the builtin flavor.
DEFAULT_RETRYABLE_ERRORS: tuple[type[BaseException], ...] = (
    TransientStorageError,
    ConnectionError,
    TimeoutError,
)


class RetryPolicy:
    """Exponential backoff + full jitter + bounded attempts + overall deadline.

    ``max_attempts`` counts the first try: ``max_attempts=5`` means at most
    4 retries. The delay before retry *k* (1-based) is drawn uniformly from
    ``[0, min(max_backoff, initial_backoff * multiplier**(k-1))]``. A retry
    whose delay would overrun ``deadline`` seconds since the first attempt is
    not taken — the last error surfaces instead, so a dead backend fails in
    bounded time rather than hanging a worker.

    ``sleep``/``clock``/``rng`` are injectable for deterministic tests.
    """

    def __init__(
        self,
        max_attempts: int = 5,
        initial_backoff: float = 0.05,
        max_backoff: float = 2.0,
        multiplier: float = 2.0,
        deadline: float | None = 60.0,
        retryable: (
            Sequence[type[BaseException]] | Callable[[BaseException], bool]
        ) = DEFAULT_RETRYABLE_ERRORS,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        rng: random.Random | None = None,
    ) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1.")
        if initial_backoff < 0 or max_backoff < 0 or multiplier < 1.0:
            raise ValueError("Backoff parameters must be non-negative, multiplier >= 1.")
        self.max_attempts = max_attempts
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.multiplier = multiplier
        self.deadline = deadline
        if isinstance(retryable, type) and issubclass(retryable, BaseException):
            # A bare exception class is callable, so without this it would be
            # mistaken for a predicate (and constructing it is always truthy).
            retryable = (retryable,)
        self._retryable = retryable
        self._sleep = sleep
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()

    def is_retryable(self, err: BaseException) -> bool:
        if callable(self._retryable) and not isinstance(self._retryable, (tuple, list)):
            return bool(self._retryable(err))
        return isinstance(err, tuple(self._retryable))

    def backoff_cap(self, attempt: int) -> float:
        """Upper bound of the jitter window before retry ``attempt`` (1-based).

        The exponent is clamped: an unbounded attempt counter (the journal
        lock polls through this schedule) would overflow ``float`` around
        attempt ~1800 and crash the very loop that was patiently waiting.
        """
        if self.initial_backoff <= 0.0:
            return 0.0
        try:
            grown = self.initial_backoff * self.multiplier ** min(attempt - 1, 256)
        except OverflowError:
            return self.max_backoff
        return min(self.max_backoff, grown)

    def jitter(self, cap: float) -> float:
        """A full-jitter delay for an externally-supplied cap — uniform in
        ``[0, cap]``, the same decorrelation :meth:`next_delay` applies to
        this policy's own backoff ladder. The thin client's shed
        retry-after sleeps draw through here so a burst of clients shed on
        the same tick does not wake as a synchronized herd against the
        recovering hub."""
        return self._rng.uniform(0.0, max(0.0, float(cap)))

    def next_delay(self, attempt: int) -> float:
        return self.jitter(self.backoff_cap(attempt))

    def backoff(
        self, attempt: int, announce: Callable[[float], None] | None = None
    ) -> float:
        """Draw attempt's jittered delay and sleep it (through the injected
        sleep); returns the delay. ``announce`` is called with the drawn
        delay *before* the sleep, so callers can log the stall while it is
        happening rather than after it already ended. For callers that run
        their own retry loop but want this policy's schedule — the
        vectorized executor's OOM batch-halving backs off through here
        between re-dispatches."""
        delay = self.next_delay(attempt)
        if announce is not None:
            announce(delay)
        self._sleep(delay)
        return delay

    def call(
        self,
        fn: Callable[[], Any],
        *,
        describe: str = "storage call",
        is_retryable: Callable[[BaseException], bool] | None = None,
        on_retry: Callable[[BaseException, int, float], None] | None = None,
    ) -> Any:
        """Run ``fn`` under this policy; return its result or raise the last
        error once attempts/deadline are spent. ``on_retry(err, attempt,
        delay)`` fires before each backoff sleep (the gRPC client reconnects
        its channel there)."""
        classify = is_retryable if is_retryable is not None else self.is_retryable
        start = self._clock()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as err:  # retry kernel: the injected classifier decides retryability; non-retryable errors re-raise unchanged
                attempt += 1
                if not classify(err) or attempt >= self.max_attempts:
                    raise
                delay = self.next_delay(attempt)
                if (
                    self.deadline is not None
                    and self._clock() - start + delay > self.deadline
                ):
                    raise
                telemetry.count("storage.retry")
                _logger.warning(
                    f"{describe} failed transiently ({err!r}); "
                    f"retry {attempt}/{self.max_attempts - 1} in {delay:.3f}s."
                )
                if on_retry is not None:
                    on_retry(err, attempt, delay)
                self._sleep(delay)


#: Methods whose blind replay could double-apply (a second trial created).
NON_IDEMPOTENT_METHODS = frozenset({"create_new_trial", "create_new_trials"})

#: Superset of the above: methods whose replay after a committed-but-unacked
#: first attempt is observably wrong. A replayed WAITING->RUNNING claim CAS
#: reports a lost race to its own winner; a replayed terminal-state or param
#: write raises against the now-finished/claimed trial; a replayed study
#: create raises DuplicatedStudyError (or mints a second auto-named study)
#: and a replayed delete raises KeyError. The remaining mutators (attrs,
#: intermediate values, heartbeats) are last-write-wins overwrites, safe to
#: replay.
REPLAY_UNSAFE_METHODS = NON_IDEMPOTENT_METHODS | frozenset(
    {
        "set_trial_state_values",
        "set_trial_param",
        "create_new_study",
        "delete_study",
    }
)


class RetryingStorage(_ForwardingStorage):
    """Wrap any storage so transient faults are absorbed by ``RetryPolicy``.

    Replay-unsafe writes (:data:`REPLAY_UNSAFE_METHODS`: trial creates, the
    claim CAS, param writes) are passed through *without* retry unless
    ``retry_non_idempotent=True``: replaying them is safe only when the
    caller knows failures strike before the backend commits (e.g. under
    :class:`~optuna_tpu_torch.testing.fault_injection.FaultInjectorStorage`) or the
    backend dedupes replays itself (the gRPC proxy's op tokens — which is why
    the proxy retries internally rather than through this wrapper).
    """

    def __init__(
        self,
        backend: BaseStorage,
        policy: RetryPolicy | None = None,
        *,
        retry_non_idempotent: bool = False,
    ) -> None:
        super().__init__(backend)
        self._policy = policy if policy is not None else RetryPolicy()
        self._retry_non_idempotent = retry_non_idempotent

    def _forward(self, method: str, *args: Any, **kwargs: Any) -> Any:
        # One logical storage op = one span, retries and backoff included —
        # the latency the *study loop* experiences, not the backend's. The
        # span covers the replay-unsafe pass-through too: trial creates and
        # the tell-path state commit are exactly the write latencies a
        # phase-regression hunt needs visible.
        with telemetry.span("storage.op"):
            if method in REPLAY_UNSAFE_METHODS and not self._retry_non_idempotent:
                return super()._forward(method, *args, **kwargs)
            return self._policy.call(
                lambda: _ForwardingStorage._forward(self, method, *args, **kwargs),
                describe=f"{type(self._backend).__name__}.{method}",
            )
