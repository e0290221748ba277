"""gRPC proxy server wrapping any BaseStorage (port of
``optuna_tpu/storages/_grpc/server.py``).

Parity target: ``optuna/storages/_grpc/server.py:27-84`` +
``servicer.py:35`` — thousands of workers talk gRPC to one process that owns
the real storage, so the backing store sees a single client.

Two layers. :func:`_make_dispatch` is the whole request path — wire decode,
op-token dedupe, storage or suggestion-service dispatch, wire encode — as a
plain ``bytes -> bytes`` function that imports no ``grpc``: a process
without ``grpc`` drives a hub through it directly (the in-process
:class:`~optuna_tpu_torch.testing.fault_injection.FakeHubFleet` does).
:func:`_make_handler`, :func:`make_grpc_server` and
:func:`run_grpc_proxy_server` import ``grpc`` when called and put that
function behind a real listener.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent import futures
from typing import TYPE_CHECKING, Callable

from optuna_tpu_torch import flight, locksan, telemetry
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages._base import BaseStorage
from optuna_tpu_torch.storages._grpc._service import (
    FLIGHT_CTX_KEY,
    METHODS,
    OP_TOKEN_KEY,
    SERVICE_NAME,
    SUGGEST_METHODS,
    WireVersionError,
    decode_request,
    encode_response,
)

if TYPE_CHECKING:
    import grpc

    from optuna_tpu_torch.storages._grpc.suggest_service import SuggestService

_logger = get_logger(__name__)

# Completed-op replay memory: enough to cover any plausible in-flight retry
# window (a client retries within seconds; thousands of creates/sec would
# still keep a token alive for minutes) without unbounded growth.
_OP_TOKEN_CACHE_SIZE = 8192


def _make_dispatch(
    storage: BaseStorage, suggest_service: "SuggestService | None" = None
) -> Callable[[bytes], bytes]:
    """The server's request path as ``dispatch(request_bytes) -> response
    bytes``: never raises, and every failure is an encoded error response."""
    from optuna_tpu_torch.logging import warn_once
    from optuna_tpu_torch.storages._grpc.client import OP_TOKEN_REPLAY_WINDOW_S

    _HEARTBEAT_DEFAULTS = {
        "get_heartbeat_interval": None,
        "_get_stale_trial_ids": [],
        "record_heartbeat": None,
        "get_failed_trial_callback": None,
    }

    # token -> (encoded successful response, monotonic insert time).
    # Replaying the recorded bytes (not re-executing) makes client retries of
    # replay-unsafe writes exactly-once: the first execution's trial id comes
    # back on every replay. The insert time is the eviction age floor's
    # evidence: an entry evicted younger than the client retry window
    # (``OP_TOKEN_REPLAY_WINDOW_S``) could still receive a legal retry that
    # would now silently re-execute — counted loud as
    # ``grpc.op_token_evicted_live`` instead of discovered as a double-apply.
    # `token_in_flight` coalesces a retry that arrives while the original is
    # STILL EXECUTING (connection died mid-call): the latecomer waits for the
    # owner to finish instead of racing it into a double-apply.
    token_cache: "OrderedDict[str, tuple[bytes, float]]" = OrderedDict()
    token_in_flight: dict = {}  # token -> threading.Event
    token_lock = locksan.lock("server.op_token")

    def dispatch(request_bytes: bytes) -> bytes:
        try:
            method_name, args, kwargs = decode_request(request_bytes)
        except WireVersionError as e:
            return encode_response(False, e)
        except Exception as e:  # security boundary: malformed wire bytes of any flavor are rejected, the server never crashes on input
            return encode_response(False, ValueError(f"Malformed request: {e}"))
        is_suggest = suggest_service is not None and method_name in SUGGEST_METHODS
        if method_name not in METHODS and not is_suggest:
            return encode_response(False, ValueError(f"Unknown method {method_name!r}"))
        # Always stripped (the storage must never see the wire-plumbing
        # kwarg); only *used* when this server records flight events.
        flight_ctx = kwargs.pop(FLIGHT_CTX_KEY, None) if isinstance(kwargs, dict) else None
        op_token = kwargs.pop(OP_TOKEN_KEY, None) if isinstance(kwargs, dict) else None
        if op_token is not None:
            while True:
                with token_lock:
                    replay = token_cache.get(op_token)
                    pending = None
                    if replay is None:
                        pending = token_in_flight.get(op_token)
                        if pending is None:
                            # We own this token's execution.
                            token_in_flight[op_token] = threading.Event()
                if replay is not None:
                    telemetry.count("grpc.op_token_dedup")
                    _logger.info(
                        f"Replaying recorded response for retried {method_name} "
                        f"(op token {op_token[:8]}...)."
                    )
                    return replay[0]
                if pending is None:
                    break  # owner: fall through and execute
                # Original attempt still executing; wait, then re-check the
                # cache (a failed original is not cached — re-loop claims
                # ownership and re-executes, matching the error semantics).
                pending.wait(timeout=120.0)
        if is_suggest and op_token is not None:
            # The fleet layer replicates suggest answers under the token so
            # a redialed ask dedupes on a SUCCESSOR hub — this in-process
            # cache cannot survive a hub death, so the token must reach the
            # service instead of being stripped here.
            kwargs["op_token"] = op_token
        if method_name in _HEARTBEAT_DEFAULTS and not hasattr(storage, method_name):
            # Backing storage without heartbeat support: behave as disabled.
            return encode_response(True, _HEARTBEAT_DEFAULTS[method_name])
        response = error_response = None
        try:
            # The handler span carries the *client's* trace/span ids (when it
            # sent them), so client timeline and server timeline stitch into
            # one trace even across machines.
            with flight.rpc_span("server", method_name, flight_ctx):
                target = suggest_service if is_suggest else storage
                result = getattr(target, method_name)(*args, **kwargs)
            response = encode_response(True, result)
        except Exception as e:  # exceptions ride the wire: every storage error is encoded and re-raised client-side, not handled here
            # Failures are NOT recorded: a retry after an app-level error
            # should re-execute, not replay the error.
            error_response = encode_response(False, e)
        finally:
            if op_token is not None:
                evicted_live: list[float] = []
                with token_lock:
                    if response is not None:
                        token_cache[op_token] = (response, time.monotonic())
                        while len(token_cache) > _OP_TOKEN_CACHE_SIZE:
                            _, (_, born) = token_cache.popitem(last=False)
                            age = time.monotonic() - born
                            if age < OP_TOKEN_REPLAY_WINDOW_S:
                                evicted_live.append(age)
                    waiter = token_in_flight.pop(op_token, None)
                if waiter is not None:
                    waiter.set()
                for age in evicted_live:
                    # A still-replayable entry fell off the LRU: the cache is
                    # undersized for this token churn, and a delayed retry of
                    # the evicted op would now silently re-execute a
                    # replay-unsafe write. Loud counter + one warning (the
                    # counter keeps counting; the log does not flood).
                    telemetry.count(
                        "grpc.op_token_evicted_live",
                        meta={"layer": "server", "age_s": round(age, 3)},
                    )
                    warn_once(
                        _logger,
                        "op_token_evicted_live",
                        f"op-token cache evicted an entry only {age:.1f}s old "
                        f"(< {OP_TOKEN_REPLAY_WINDOW_S:.0f}s retry window): a "
                        f"delayed duplicate of that op would re-execute; raise "
                        f"_OP_TOKEN_CACHE_SIZE for this churn rate.",
                    )
        return response if response is not None else error_response

    return dispatch


def _make_handler(storage: BaseStorage, suggest_service: "SuggestService | None" = None):
    """A ``grpc.GenericRpcHandler`` serving :func:`_make_dispatch`."""
    import grpc

    dispatch = _make_dispatch(storage, suggest_service)

    def handle(request_bytes: bytes, context) -> bytes:
        return dispatch(request_bytes)

    class Handler(grpc.GenericRpcHandler):
        def service(self, handler_call_details):
            if not handler_call_details.method.startswith(f"/{SERVICE_NAME}/"):
                return None
            return grpc.unary_unary_rpc_method_handler(
                handle,
                request_deserializer=None,
                response_serializer=None,
            )

    return Handler()


def make_grpc_server(
    storage: BaseStorage,
    host: str = "localhost",
    port: int = 13000,
    thread_pool_size: int = 10,
    suggest_service: "SuggestService | None" = None,
):
    import grpc

    if suggest_service is not None:
        # Tells flow through the service's observer so speculative ask-ahead
        # refills on fresh evidence; suggest RPCs dispatch to the service.
        storage = suggest_service.wrap_storage(storage)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=thread_pool_size))
    server.add_generic_rpc_handlers((_make_handler(storage, suggest_service),))
    server.add_insecure_port(f"{host}:{port}")
    return server


def run_grpc_proxy_server(
    storage: BaseStorage,
    *,
    host: str = "localhost",
    port: int = 13000,
    thread_pool_size: int = 10,
    drain_grace: float | None = 15.0,
    metrics_port: int | None = None,
    suggest_service: "SuggestService | None" = None,
    fleet_hubs: "list[str] | None" = None,
    fleet_name: str | None = None,
) -> None:
    """Blocking server entry point (reference ``server.py:38``).

    SIGTERM/SIGINT trigger a graceful drain: the listener stops accepting new
    RPCs immediately, in-flight calls get ``drain_grace`` seconds to finish
    (then are cancelled), and only afterwards does the process return —
    clients see clean completions or UNAVAILABLE-on-connect, which their
    retry policy absorbs, never a half-written response.

    ``metrics_port`` additionally serves the process's telemetry registry
    over HTTP (``/metrics`` Prometheus text, ``/metrics.json`` snapshot —
    :func:`optuna_tpu_torch.telemetry.serve_metrics`) and turns recording on —
    metrics AND the flight recorder, whose Chrome-trace export is served at
    ``/trace.json`` beside them, AND the study doctor's ``/health.json``
    (per-study fleet reports aggregated from the worker snapshots in the
    backing storage — :func:`optuna_tpu_torch.health.storage_health_reports`),
    AND the SLO engine, whose quantile/compliance/burn report is served at
    ``/slo.json`` (and as ``optuna_tpu_slo_*`` gauges inside ``/metrics``):
    the storage hub is where op-token dedup hits, server-side storage
    latencies live, every worker's trace ids cross, and every worker's
    health snapshot lands, so this one endpoint watches a fleet.

    ``fleet_hubs`` (the full endpoint-named hub list, this hub included)
    turns this server into a member of a hub fleet: the suggestion service
    is wrapped in a :class:`~optuna_tpu_torch.storages._grpc.fleet.FleetHub`
    named ``fleet_name`` (default ``host:port``), which forwards mis-routed
    asks to their owners, replicates answered asks to the shared storage,
    and sheds overload to the least-burning peer before rejecting.
    """
    import signal

    from optuna_tpu_torch import health

    from optuna_tpu_torch import slo

    if fleet_hubs and suggest_service is not None:
        from optuna_tpu_torch.storages._grpc import fleet as fleet_mod

        suggest_service = fleet_mod.attach_hub(
            suggest_service,
            storage,
            list(fleet_hubs),
            fleet_name or f"{host}:{port}",
        )
    server = make_grpc_server(storage, host, port, thread_pool_size, suggest_service)
    metrics_server = None
    if metrics_port is not None:
        telemetry.enable()
        flight.enable()
        # The hub is exactly the process whose latency promises the SLO
        # engine binds (serve.ask, storage.op), so the metrics knob arms it
        # too — /slo.json answers with live burn rates, and the shed
        # policy's default SLO feed starts reacting.
        slo.enable()
        metrics_server = telemetry.serve_metrics(
            metrics_port,
            host=host,
            health_source=lambda: health.storage_health_reports(storage),
        )
        _logger.info(f"Telemetry endpoint at http://{host}:{metrics_port}/metrics")
        _logger.info(f"Flight-trace endpoint at http://{host}:{metrics_port}/trace.json")
        _logger.info(f"Study-doctor endpoint at http://{host}:{metrics_port}/health.json")
        _logger.info(f"SLO endpoint at http://{host}:{metrics_port}/slo.json")
    server.start()
    _logger.info(f"Server started at {host}:{port}")
    _logger.info("Listening...")

    def _drain(signum: int, frame) -> None:
        _logger.info(
            f"Signal {signum}: draining (refusing new RPCs, "
            f"up to {drain_grace}s for in-flight calls)..."
        )
        if suggest_service is not None:
            # Flush the open coalesce window FIRST: askers parked mid-window
            # get their batch dispatched and answered before the listener
            # refuses new RPCs — a SIGTERM never strands a coalesced ask.
            suggest_service.drain()
        server.stop(grace=drain_grace)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _drain)
        except ValueError:
            pass  # not the main thread; caller owns signal handling
    server.wait_for_termination()
    if suggest_service is not None:
        suggest_service.close()
    if metrics_server is not None:
        metrics_server.shutdown()
    try:
        storage.remove_session()
    except Exception:  # shutdown teardown: a failing session release must not mask a clean drain
        pass
    _logger.info("Server drained; storage session released.")
