"""netchaos: a deterministic, plan-driven network-fault layer (port of
``optuna_tpu/testing/netchaos.py``; ``grpc`` is imported only by the
real-channel taps).

:mod:`~optuna_tpu_torch.testing.fault_injection` injects *storage* faults (the
backend misbehaves); this module injects *transport* faults — the network
between a client and a suggestion hub misbehaves while both endpoints stay
healthy. That is the gray-failure regime the lease fence
(:mod:`optuna_tpu_torch.storages._grpc.fleet`) exists for: a hub that is neither
up nor down, reachable by some peers and not others, whose committed
responses never arrive.

One :class:`NetChaos` engine applies one seeded :class:`NetChaosPlan` to
any number of links, on both serve transports:

* the handler-direct path — :meth:`NetChaos.attach_fleet` rewraps a
  :class:`~optuna_tpu_torch.testing.fault_injection.FakeHubFleet`'s per-hub RPC
  closures, so client asks AND hub-to-hub peer forwarding cross the chaos
  layer;
* a real loopback gRPC channel — :meth:`NetChaos.intercept` returns the
  channel routed through a ``grpc.UnaryUnaryClientInterceptor``, and
  :meth:`NetChaos.wrap_proxy` pins a
  :class:`~optuna_tpu_torch.storages._grpc.client.GrpcStorageProxy` (reconnects
  included) through it.

Fault vocabulary (per link, per logical method):

=============  ==========================================================
delay          sleep ``delay_s`` before delivering the request
drop           the request never arrives (raised as UNAVAILABLE-shaped)
duplicate      the request is delivered twice — the second delivery rides
               the same bytes and op token, so dedupe must collapse it
reorder        delivery is held until the link's next request passes (or
               ``reorder_hold_s`` expires), swapping arrival order
partition      imperative taps: :meth:`partition` with ``"symmetric"``
               drops requests outright; ``"oneway"`` lets the request
               commit server-side and drops only the response — the
               committed-but-unacked case the op-token machinery dedupes
pause/resume   :meth:`pause` parks every call at the chaos layer until
               :meth:`resume` (bounded by ``pause_max_s``) — a stall, not
               a failure: nothing errors, everything arrives late
=============  ==========================================================

Determinism: explicit per-method call-index ``schedules`` replay
identically under any interleaving; the probabilistic ``*_rate`` knobs are
seeded per link (one ``random.Random`` per peer) and replay identically
for a single-threaded caller. Faults strike exactly once per decision and
are counted in :attr:`NetChaos.injected` for assertions.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from optuna_tpu_torch.logging import get_logger

_logger = get_logger(__name__)

#: Schedule key matching every logical method on the link.
ANY_METHOD = "*"


@dataclass(frozen=True)
class NetChaosPlan:
    """Declarative description of the transport faults to inject, and when.

    ``drop``/``delay``/``duplicate``/``reorder`` map a logical method name
    (or :data:`ANY_METHOD`) to the 0-based call indices — counted per
    (link, method) — that MUST fault: the fully deterministic mode. The
    ``*_rate`` knobs are seeded per-link probabilities; ``methods`` limits
    probabilistic faults to a subset (scheduled faults always apply);
    ``max_faults`` caps the probabilistic total so a finite retry budget
    always wins eventually (scheduled faults are exempt — a schedule is a
    promise).
    """

    seed: int = 0
    drop_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.005
    duplicate_rate: float = 0.0
    reorder_rate: float = 0.0
    methods: frozenset[str] | None = None
    drop: Mapping[str, Sequence[int]] = field(default_factory=dict)
    delay: Mapping[str, Sequence[int]] = field(default_factory=dict)
    duplicate: Mapping[str, Sequence[int]] = field(default_factory=dict)
    reorder: Mapping[str, Sequence[int]] = field(default_factory=dict)
    max_faults: int | None = None
    #: How long a reordered request waits for the link's next request
    #: before delivering anyway (a lone in-flight request cannot swap with
    #: anything; the hold degrades to a delay).
    reorder_hold_s: float = 0.2
    #: Upper bound on a paused call's wait: a forgotten :meth:`resume`
    #: must stall the test, not hang it.
    pause_max_s: float = 5.0


class NetChaos:
    """Apply one :class:`NetChaosPlan` to named links.

    The engine is transport-agnostic: :meth:`apply` takes the link name,
    the logical method, the ``execute`` thunk that performs the real send,
    and an ``unavailable`` exception factory shaped for that transport
    (``HubUnavailableError`` on the handler path, an UNAVAILABLE-coded
    ``grpc.RpcError`` on a real channel) — so the layers above see exactly
    the failure shape their retry/redial machinery classifies.
    """

    def __init__(self, plan: NetChaosPlan | None = None) -> None:
        self.plan = plan if plan is not None else NetChaosPlan()
        #: Injected-fault totals by kind (``drop``, ``delay``, ``duplicate``,
        #: ``reorder``, ``partition_drop``, ``partition_oneway``, ``pause``).
        self.injected: dict[str, int] = {}
        #: Per-(link, method) delivered-call indices, for schedule planning.
        self.calls: dict[tuple[str, str], int] = {}
        self._rngs: dict[str, random.Random] = {}
        self._partitions: dict[str, str] = {}
        self._pauses: dict[str, threading.Event] = {}
        self._probabilistic_faults = 0
        self._arrivals: dict[str, int] = {}
        self._mutex = threading.Lock()
        self._reorder_cond = threading.Condition(self._mutex)

    # ------------------------------------------------------ imperative taps

    def partition(self, peer: str, mode: str = "symmetric") -> None:
        """Partition the link to ``peer``: ``"symmetric"`` drops requests
        before they arrive; ``"oneway"`` delivers (and commits) the request
        and drops the response — the asymmetric half-open link."""
        if mode not in ("symmetric", "oneway"):
            raise ValueError(f"unknown partition mode {mode!r}")
        with self._mutex:
            self._partitions[peer] = mode

    def heal(self, peer: str) -> None:
        """The partition to ``peer`` heals: traffic flows again."""
        with self._mutex:
            self._partitions.pop(peer, None)

    def pause(self, peer: str) -> None:
        """Park every call on the link until :meth:`resume` — a stall
        (GC pause, routing flap), not a failure: nothing errors."""
        with self._mutex:
            event = self._pauses.get(peer)
            if event is None or event.is_set():
                self._pauses[peer] = threading.Event()

    def resume(self, peer: str) -> None:
        with self._mutex:
            event = self._pauses.pop(peer, None)
        if event is not None:
            event.set()

    # ------------------------------------------------------------- engine

    def _count(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def _decide(self, peer: str, method: str) -> list[str]:
        plan = self.plan
        faults: list[str] = []
        with self._mutex:
            key = (peer, method)
            index = self.calls.get(key, 0)
            self.calls[key] = index + 1
            rng = self._rngs.get(peer)
            if rng is None:
                rng = self._rngs[peer] = random.Random(f"{plan.seed}:{peer}")
            for kind, table, rate in (
                ("drop", plan.drop, plan.drop_rate),
                ("delay", plan.delay, plan.delay_rate),
                ("duplicate", plan.duplicate, plan.duplicate_rate),
                ("reorder", plan.reorder, plan.reorder_rate),
            ):
                scheduled = index in tuple(table.get(method, ())) or index in tuple(
                    table.get(ANY_METHOD, ())
                )
                probabilistic = False
                if not scheduled and rate > 0.0:
                    if plan.methods is None or method in plan.methods:
                        budget_open = (
                            plan.max_faults is None
                            or self._probabilistic_faults < plan.max_faults
                        )
                        probabilistic = budget_open and rng.random() < rate
                if scheduled or probabilistic:
                    faults.append(kind)
                    if probabilistic:
                        self._probabilistic_faults += 1
                    self._count(kind)
        return faults

    def _signal_arrival(self, peer: str) -> None:
        with self._reorder_cond:
            self._arrivals[peer] = self._arrivals.get(peer, 0) + 1
            self._reorder_cond.notify_all()

    def _hold_for_next(self, peer: str) -> None:
        """Block until another request arrives on the link (its delivery
        then precedes this one: arrival order swapped) or the hold expires
        (a lone request has nothing to swap with)."""
        deadline = time.monotonic() + self.plan.reorder_hold_s
        with self._reorder_cond:
            seen = self._arrivals.get(peer, 0)
            while self._arrivals.get(peer, 0) == seen:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._reorder_cond.wait(remaining)

    def apply(
        self,
        peer: str,
        method: str,
        execute: Callable[[], Any],
        unavailable: Callable[[str], BaseException],
    ) -> Any:
        """Deliver one request through the chaos layer."""
        self._signal_arrival(peer)
        with self._mutex:
            gate = self._pauses.get(peer)
            mode = self._partitions.get(peer)
        if gate is not None and not gate.is_set():
            self._count("pause")
            gate.wait(self.plan.pause_max_s)
        if mode == "symmetric":
            self._count("partition_drop")
            raise unavailable(
                f"netchaos: symmetric partition — request to {peer!r} "
                f"({method}) never arrived"
            )
        faults = self._decide(peer, method)
        if "drop" in faults:
            raise unavailable(
                f"netchaos: request to {peer!r} ({method}) dropped"
            )
        if "delay" in faults:
            time.sleep(self.plan.delay_s)
        if "reorder" in faults:
            self._hold_for_next(peer)
        result = execute()
        if "duplicate" in faults:
            # Same bytes, same op token: the duplicate delivery's answer is
            # what the wire would hand a client that saw both — dedupe must
            # make it indistinguishable from the first.
            result = execute()
        if mode == "oneway":
            self._count("partition_oneway")
            raise unavailable(
                f"netchaos: one-way partition — {peer!r} committed {method} "
                "but the response was dropped (committed-but-unacked)"
            )
        return result

    # ------------------------------------------- handler-direct transport

    def wrap_rpc(
        self, peer: str, rpc: Callable[..., Any]
    ) -> Callable[..., Any]:
        """Wrap one ``rpc(method, *args, **kwargs)`` closure (the
        :class:`FakeHubFleet` per-hub shape) in this chaos layer."""
        from optuna_tpu_torch.storages._grpc.fleet import HubUnavailableError

        def chaotic(method: str, *args: Any, **kwargs: Any) -> Any:
            return self.apply(
                peer,
                method,
                lambda: rpc(method, *args, **kwargs),
                HubUnavailableError,
            )

        return chaotic

    def attach_fleet(self, fleet: Any) -> None:
        """Route every RPC of a :class:`~optuna_tpu_torch.testing.
        fault_injection.FakeHubFleet` — client asks and hub-to-hub peer
        forwarding alike — through this chaos layer, keyed by hub name."""
        for name, rpc in list(fleet._rpc.items()):
            fleet._rpc[name] = self.wrap_rpc(name, rpc)

    # ------------------------------------------------- real gRPC transport

    def intercept(self, channel: Any, peer: str = "server") -> Any:
        """The channel, routed through this chaos layer (a
        ``UnaryUnaryClientInterceptor``). The logical method is recovered
        from the RPC path (``/<service>/<method>``), so schedules key the
        same way on both transports."""
        import grpc

        chaos = self

        class _ChaosRpcError(grpc.RpcError):
            def __init__(self, message: str) -> None:
                super().__init__(message)
                self._message = message

            def code(self) -> Any:
                return grpc.StatusCode.UNAVAILABLE

            def details(self) -> str:
                return self._message

        class _Interceptor(grpc.UnaryUnaryClientInterceptor):
            def intercept_unary_unary(
                self, continuation, client_call_details, request
            ):
                method = str(client_call_details.method).rsplit("/", 1)[-1]
                return chaos.apply(
                    peer,
                    method,
                    lambda: continuation(client_call_details, request),
                    _ChaosRpcError,
                )

        return grpc.intercept_channel(channel, _Interceptor())

    def wrap_proxy(self, proxy: Any, peer: str = "server") -> Any:
        """Pin a :class:`~optuna_tpu_torch.storages._grpc.client.
        GrpcStorageProxy` through this chaos layer — including every
        channel its reconnect path re-dials."""
        original_setup = proxy._setup

        def setup() -> None:
            original_setup()
            proxy._channel = self.intercept(proxy._channel, peer=peer)

        proxy._setup = setup
        if proxy._channel is not None:
            proxy._channel = self.intercept(proxy._channel, peer=peer)
        return proxy
