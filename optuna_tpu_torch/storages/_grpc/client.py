"""gRPC storage proxy client implementing BaseStorage over a channel (port
of ``optuna_tpu/storages/_grpc/client.py``).

Parity target: ``optuna/storages/_grpc/client.py:46`` — every storage call
becomes one RPC; server-side exceptions are re-raised locally.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Container, Sequence

from optuna_tpu_torch import flight, telemetry
from optuna_tpu_torch.distributions import BaseDistribution
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages._base import BaseStorage
from optuna_tpu_torch.storages._grpc._service import (
    FLIGHT_CTX_KEY,
    OP_TOKEN_KEY,
    SERVICE_NAME,
    decode_response,
    encode_request,
)
from optuna_tpu_torch.storages._heartbeat import BaseHeartbeat
from optuna_tpu_torch.storages._retry import RetryPolicy
from optuna_tpu_torch.study._frozen import FrozenStudy
from optuna_tpu_torch.study._study_direction import StudyDirection
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState


_logger = get_logger(__name__)

# Wire-protocol constant: the RPCs that carry a client-minted dedupe op
# token. Deliberately a literal, NOT an import of
# ``storages._retry.REPLAY_UNSAFE_METHODS``: the server's dedupe behavior is
# a wire contract, and silently inheriting a changed retry-layer set would
# change what old servers dedupe without anyone touching this file. The
# tests hold this copy against the retry layer's set and the reference's.
_OP_TOKEN_METHODS = frozenset(
    {
        "create_new_study",
        "delete_study",
        "create_new_trial",
        "create_new_trials",
        "set_trial_param",
        "set_trial_state_values",
    }
)

# Per-attempt RPC bound used when the policy's overall deadline is disabled
# (deadline=None): a single attempt against a wedged server must still fail
# in bounded time so the retry loop can engage.
_UNBOUNDED_ATTEMPT_TIMEOUT = 120.0

# The op-token replay window: the longest interval after a replay-unsafe
# write completes during which a retry of it can still legally arrive, so
# the longest its recorded response must stay replayable. It equals the
# per-attempt bound above because that is the outermost client-side clock:
# every retry policy's overall deadline is either finite and enforced by
# the client, or None — in which case each attempt is individually capped
# at ``_UNBOUNDED_ATTEMPT_TIMEOUT``, after which the client stops retrying
# that attempt and mints no further use of the token. Dedupe caches on the
# other side (the server's in-process LRU, the fleet's shared replay ring)
# compare evicted-entry ages against this window: evicting an entry YOUNGER
# than it risks silently re-executing a write, which is exactly what the
# loud ``grpc.op_token_evicted_live`` counter reports.
OP_TOKEN_REPLAY_WINDOW_S = _UNBOUNDED_ATTEMPT_TIMEOUT


def _default_retry_policy() -> RetryPolicy:
    # UNAVAILABLE during a proxy-server restart resolves in seconds; five
    # full-jitter attempts cover ~4s of outage without hammering the server.
    return RetryPolicy(max_attempts=5, initial_backoff=0.1, max_backoff=2.0, deadline=60.0)


def is_transport_unavailable(err: BaseException) -> bool:
    """True for the transport-level UNAVAILABLE shape: the peer process is
    gone (dead, restarting, partitioned away), not merely slow. One
    classifier shared by this proxy's retry loop and the fleet client's
    redial-next-replica walk (``fleet.FleetClient``) — the two must agree
    on what "the hub is unreachable" looks like, or a failover redial and a
    same-hub retry would race each other."""
    try:
        import grpc
    except ImportError:  # no grpc in this process: nothing transport-shaped
        return False
    if not isinstance(err, grpc.RpcError):
        return False
    try:
        return err.code() == grpc.StatusCode.UNAVAILABLE
    except Exception:  # a half-constructed RpcError without a status code is not classifiable; treat as not-unavailable rather than crash the classifier
        return False


class GrpcStorageProxy(BaseStorage, BaseHeartbeat):
    """BaseStorage over a gRPC channel, resilient to transient transport
    failures: calls that die with UNAVAILABLE / DEADLINE_EXCEEDED are replayed
    under ``retry_policy`` (reconnecting the channel between attempts), and
    replay-unsafe writes carry a client-generated op token the server dedupes,
    so a retried create cannot mint a duplicate trial while the server process
    lives (the dedupe memory is in-process; a server crash inside the narrow
    committed-but-unacked window remains a single-trial risk). Pass
    ``retry_policy=RetryPolicy(max_attempts=1)`` to disable retries."""

    def __init__(
        self,
        *,
        host: str = "localhost",
        port: int = 13000,
        retry_policy: RetryPolicy | None = None,
    ) -> None:
        self._host = host
        self._port = port
        self._channel = None
        self._retry_policy = retry_policy if retry_policy is not None else _default_retry_policy()
        # Set when the server proves it predates FLIGHT_CTX_KEY (it forwarded
        # the kwarg into the storage and got a TypeError): trace propagation
        # is observability, so it degrades to client-side-only spans instead
        # of failing every op against an older hub.
        self._flight_ctx_unsupported = False
        self._setup()

    def _setup(self) -> None:
        import grpc

        self._channel = grpc.insecure_channel(f"{self._host}:{self._port}")

    def _reconnect(self) -> None:
        """Drop the (possibly wedged) channel and dial a fresh one — a
        restarted server presents a new connection the old channel's HTTP/2
        session does not always recover on its own."""
        telemetry.count("grpc.redial")
        old, self._channel = self._channel, None
        if old is not None:
            try:
                old.close()
            except Exception:  # a wedged channel may fail close() in grpc-internal ways; reconnect must proceed regardless
                pass
        self._setup()

    def __getstate__(self) -> dict[str, Any]:
        state = self.__dict__.copy()
        state["_channel"] = None
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._setup()

    def _call(self, method: str, *args: Any, **kwargs: Any) -> Any:
        import grpc

        if method in _OP_TOKEN_METHODS and OP_TOKEN_KEY not in kwargs:
            # One token per *logical* call, minted before the retry loop, so
            # every replay carries the same token and the server's dedupe
            # cache collapses them into one execution. A caller-supplied
            # token is kept: the fleet client redials a DIFFERENT hub's
            # proxy with the same token, and the successor's replay-record
            # lookup depends on it surviving the hop.
            kwargs = {**kwargs, OP_TOKEN_KEY: uuid.uuid4().hex}
        flight_ctx = None
        if flight.enabled() and not self._flight_ctx_unsupported:
            # Trace propagation rides beside the op token: one span id per
            # *logical* op (replays reuse it — they ARE the same op), so the
            # server's handler span parents onto exactly this client span
            # and a fleet of workers stitches into one trace id.
            flight_ctx = flight.rpc_context()
            kwargs = {**kwargs, FLIGHT_CTX_KEY: flight_ctx}
        request = encode_request(method, args, kwargs)

        def once() -> bytes:
            if self._channel is None:
                self._setup()
            rpc = self._channel.unary_unary(
                f"/{SERVICE_NAME}/{method}",
                request_serializer=None,
                response_deserializer=None,
            )
            # Per-attempt deadline: without it a wedged server (connection
            # up, storage stalled) would hang this call forever and the
            # policy's between-attempts deadline would never engage. A
            # policy with deadline=None disables the *overall* budget, not
            # the per-attempt bound — that must never be infinite.
            attempt_timeout = self._retry_policy.deadline or _UNBOUNDED_ATTEMPT_TIMEOUT
            return rpc(request, timeout=attempt_timeout)

        def transient(err: BaseException) -> bool:
            return is_transport_unavailable(err) or (
                isinstance(err, grpc.RpcError)
                and err.code() == grpc.StatusCode.DEADLINE_EXCEEDED
            )

        # One logical RPC = one storage.op span (transport retries, re-dials
        # and backoff included): the latency the study loop actually waits.
        with telemetry.span("storage.op"), flight.rpc_span("client", method, flight_ctx):
            raw = self._retry_policy.call(
                once,
                describe=f"gRPC {method} to {self._host}:{self._port}",
                is_retryable=transient,
                on_retry=lambda err, attempt, delay: self._reconnect(),
            )
        ok, payload = decode_response(raw)
        if (
            not ok
            and flight_ctx is not None
            and isinstance(payload, TypeError)
            and FLIGHT_CTX_KEY in str(payload)
        ):
            # A pre-flight-recorder server forwarded the propagation kwarg
            # into its storage call. The op itself never ran (the TypeError
            # is raised binding the arguments), so replaying WITHOUT the
            # kwarg is safe — including for op-token methods, whose token is
            # preserved in the re-encoded kwargs. Downgrade this proxy to
            # client-side-only spans for the rest of its life.
            self._flight_ctx_unsupported = True
            _logger.warning(
                f"server at {self._host}:{self._port} predates flight-trace "
                "propagation; continuing with client-side spans only."
            )
            # kwargs was rebound above: strip both injected wire kwargs so
            # the replay re-mints a fresh op token (the failed attempt never
            # bound its arguments, so nothing was executed or recorded).
            clean = {
                k: v for k, v in kwargs.items() if k not in (OP_TOKEN_KEY, FLIGHT_CTX_KEY)
            }
            return self._call(method, *args, **clean)
        if not ok:
            raise payload
        return payload

    def remove_session(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None

    # ------------------------------------------------------------------ study

    def create_new_study(
        self, directions: Sequence[StudyDirection], study_name: str | None = None
    ) -> int:
        return self._call("create_new_study", list(directions), study_name)

    def delete_study(self, study_id: int) -> None:
        self._call("delete_study", study_id)

    def set_study_user_attr(self, study_id: int, key: str, value: Any) -> None:
        self._call("set_study_user_attr", study_id, key, value)

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        self._call("set_study_system_attr", study_id, key, value)

    def get_study_id_from_name(self, study_name: str) -> int:
        return self._call("get_study_id_from_name", study_name)

    def get_study_name_from_id(self, study_id: int) -> str:
        return self._call("get_study_name_from_id", study_id)

    def get_study_directions(self, study_id: int) -> list[StudyDirection]:
        return self._call("get_study_directions", study_id)

    def get_study_user_attrs(self, study_id: int) -> dict[str, Any]:
        return self._call("get_study_user_attrs", study_id)

    def get_study_system_attrs(self, study_id: int) -> dict[str, Any]:
        return self._call("get_study_system_attrs", study_id)

    def get_all_studies(self) -> list[FrozenStudy]:
        return self._call("get_all_studies")

    # ------------------------------------------------------------------ trial

    def create_new_trial(self, study_id: int, template_trial: FrozenTrial | None = None) -> int:
        return self._call("create_new_trial", study_id, template_trial)

    def create_new_trials(
        self, study_id: int, n: int, template_trial: FrozenTrial | None = None
    ) -> list[int]:
        # One RPC creates the whole batch server-side.
        return self._call("create_new_trials", study_id, n, template_trial)

    def set_trial_param(
        self,
        trial_id: int,
        param_name: str,
        param_value_internal: float,
        distribution: BaseDistribution,
    ) -> None:
        self._call("set_trial_param", trial_id, param_name, param_value_internal, distribution)

    def get_trial_id_from_study_id_trial_number(self, study_id: int, trial_number: int) -> int:
        return self._call("get_trial_id_from_study_id_trial_number", study_id, trial_number)

    def set_trial_state_values(
        self, trial_id: int, state: TrialState, values: Sequence[float] | None = None
    ) -> bool:
        return self._call("set_trial_state_values", trial_id, state, values)

    def set_trial_intermediate_value(
        self, trial_id: int, step: int, intermediate_value: float
    ) -> None:
        self._call("set_trial_intermediate_value", trial_id, step, intermediate_value)

    def set_trial_user_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._call("set_trial_user_attr", trial_id, key, value)

    def set_trial_system_attr(self, trial_id: int, key: str, value: Any) -> None:
        self._call("set_trial_system_attr", trial_id, key, value)

    def get_trial(self, trial_id: int) -> FrozenTrial:
        return self._call("get_trial", trial_id)

    def get_trial_params(self, trial_id: int) -> dict[str, Any]:
        # Attr-only wire fetch: smaller payload than shipping the FrozenTrial.
        return self._call("get_trial_params", trial_id)

    def get_trial_user_attrs(self, trial_id: int) -> dict[str, Any]:
        return self._call("get_trial_user_attrs", trial_id)

    def get_trial_system_attrs(self, trial_id: int) -> dict[str, Any]:
        return self._call("get_trial_system_attrs", trial_id)

    def get_all_trials(
        self,
        study_id: int,
        deepcopy: bool = True,
        states: Container[TrialState] | None = None,
    ) -> list[FrozenTrial]:
        return self._call("get_all_trials", study_id, deepcopy, states)

    def _read_trials_partial(
        self, study_id: int, max_known_trial_id: int, extra_ids: Container[int]
    ) -> list[FrozenTrial]:
        # Incremental poll: the server filters, so the wire carries only new
        # trials — wrap this proxy in _CachedStorage (get_storage does) and a
        # 10k-trial study no longer ships megabytes per sampler read.
        return self._call(
            "_read_trials_partial", study_id, max_known_trial_id, sorted(set(extra_ids))
        )

    # -------------------------------------------------------------- heartbeat

    def record_heartbeat(self, trial_id: int) -> None:
        self._call("record_heartbeat", trial_id)

    def _get_stale_trial_ids(self, study_id: int) -> list[int]:
        return self._call("_get_stale_trial_ids", study_id)

    def get_heartbeat_interval(self) -> int | None:
        return self._call("get_heartbeat_interval")

    def get_failed_trial_callback(self) -> Callable | None:
        # Callables don't cross the wire; retry callbacks run server-side or
        # must be configured locally by the caller.
        return None
