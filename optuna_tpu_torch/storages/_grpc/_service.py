"""Shared wire definition for the gRPC storage proxy (port of
``optuna_tpu/storages/_grpc/_service.py``; the bytes are the reference's,
so either package's client talks to the other's server).

Parity target: ``optuna/storages/_grpc/`` (proto service + servicer +
client). The reference generates protobuf stubs with protoc; this
environment has the gRPC C-core runtime but no Python codegen plugin, so
the service rides grpc's *generic handler* API with a hand-rolled,
**versioned JSON** wire codec — same HTTP/2 transport and fan-out
properties, no generated code, and (unlike pickle) nothing on the wire can
instantiate arbitrary classes: every rich type decodes through an explicit
constructor table and unknown wire versions are rejected outright.

Every storage method is one unary-unary RPC:
request  = ``{"v": WIRE_VERSION, "m": method, "a": [...], "k": {...}}``
response = ``{"v": WIRE_VERSION, "ok": bool, "p": payload-or-error}``.
"""

from __future__ import annotations

import datetime
import json
import math
from typing import Any

from optuna_tpu_torch import exceptions as _exc
from optuna_tpu_torch.distributions import distribution_to_json, json_to_distribution

# The reference's service name, kept so the two packages share one wire.
SERVICE_NAME = "optuna_tpu.StorageProxy"
WIRE_VERSION = 1

# Reserved kwarg carrying a client-generated idempotency token on
# replay-unsafe RPCs (trial creates, state/param writes). The server strips
# it before invoking the storage and replays the recorded response for a
# repeated token, so a client retrying after a transport failure cannot
# double-apply the write. Riding in kwargs keeps the wire format (and
# WIRE_VERSION) unchanged for old clients against this server; the reverse
# skew (a token-sending client against a pre-token server) would TypeError
# on the storage call — both halves ship together in this repo, so no such
# server exists, but a future wire change must bump WIRE_VERSION instead.
OP_TOKEN_KEY = "__op_token"

# Reserved kwarg carrying the flight recorder's trace-propagation context
# (``{"t": trace_id, "s": span_id}``) on every RPC while the client has
# flight recording enabled (off by default — the wire is unchanged for
# recorders-off clients). The server strips it before invoking the storage
# and tags its handler span with the client's ids, so a multi-worker study
# renders as ONE timeline. Rides in kwargs beside the op token for the same
# skew rationale documented above; a future wire change bumps WIRE_VERSION.
FLIGHT_CTX_KEY = "__flight_ctx"


class WireVersionError(RuntimeError):
    """Peer speaks an unknown wire version."""


# The BaseStorage surface exposed over the wire.
METHODS = (
    "create_new_study",
    "delete_study",
    "set_study_user_attr",
    "set_study_system_attr",
    "get_study_id_from_name",
    "get_study_name_from_id",
    "get_study_directions",
    "get_study_user_attrs",
    "get_study_system_attrs",
    "get_all_studies",
    "create_new_trial",
    "create_new_trials",
    "set_trial_param",
    "get_trial_id_from_study_id_trial_number",
    "get_trial_number_from_id",
    "get_trial_param",
    "set_trial_state_values",
    "set_trial_intermediate_value",
    "set_trial_user_attr",
    "set_trial_system_attr",
    "get_trial",
    "get_trial_params",
    "get_trial_user_attrs",
    "get_trial_system_attrs",
    "get_all_trials",
    "_read_trials_partial",
    "get_n_trials",
    "get_best_trial",
    "record_heartbeat",
    "_get_stale_trial_ids",
    "get_heartbeat_interval",
    "get_failed_trial_callback",
)

# The suggestion-service RPCs: dispatched to the server's mounted
# SuggestService instead of the backing storage, and only accepted when one
# is mounted — a storage-only hub answers them with the same 'Unknown
# method' error as any bad name, which ThinClientSampler treats as a
# permanent downgrade to local independent sampling (wire-compatible skew,
# no WIRE_VERSION bump needed: the method namespace was already open).
# ``service_ask`` always carries an OP_TOKEN_KEY kwarg: a transport-level
# replay of an ask must return the recorded proposal, not pop a second
# ready-queue entry or mint a second proposal for the same trial.
# ``service_forwarded_ask``/``service_burn_verdict`` are the hub fleet's
# hub-to-hub channel: a hub answers a mis-routed ask for its
# owner, and hubs exchange SLO burn verdicts to pick a shed-forward target.
# Same open namespace, so still no WIRE_VERSION bump.
SUGGEST_METHODS = ("service_ask", "service_forwarded_ask", "service_burn_verdict")

# Exceptions allowed to re-materialize client-side, by name. Anything else
# becomes a plain RuntimeError carrying the message — never an arbitrary
# class lookup on attacker-controlled input.
_ERROR_TYPES: dict[str, type[Exception]] = {
    "KeyError": KeyError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    "TypeError": TypeError,
    "NotImplementedError": NotImplementedError,
    "DuplicatedStudyError": _exc.DuplicatedStudyError,
    "UpdateFinishedTrialError": _exc.UpdateFinishedTrialError,
    "StorageInternalError": _exc.StorageInternalError,
    # Typed fence rejection: a zombie hub's stale-epoch write must
    # cross the wire as StaleLeaseError so the hub-side demotion ladder (and
    # a client's never-retry classification) see the type, not a RuntimeError.
    # Additive entry, so no WIRE_VERSION bump: an old peer decodes it as a
    # plain RuntimeError carrying the same message.
    "StaleLeaseError": _exc.StaleLeaseError,
}


def _device_error_types() -> dict[str, type[Exception]]:
    """The port's device faults by wire name (``samplers._resilience.
    is_device_fault``): a hub whose kernel library did not build or whose
    card failed answers that error, and the client must see the same type,
    never a plain ``RuntimeError`` it would contain. Both subclass
    ``RuntimeError``, so the entries are additive: a reference peer decodes
    them as ``RuntimeError`` carrying the message, with no WIRE_VERSION bump.
    Imported when the first error is decoded (the kernels' build module
    belongs to the ops layer)."""
    import torch

    from optuna_tpu_torch.ops.kernels._nvcc import KernelBuildError

    table: dict[str, type[Exception]] = {"KernelBuildError": KernelBuildError}
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None:
        table["AcceleratorError"] = accelerator_error
    return table


def _enc(obj: Any) -> Any:
    """Recursively encode one value into plain JSON types."""
    from optuna_tpu_torch.distributions import BaseDistribution
    from optuna_tpu_torch.study._frozen import FrozenStudy
    from optuna_tpu_torch.study._study_direction import StudyDirection
    from optuna_tpu_torch.trial._frozen import FrozenTrial
    from optuna_tpu_torch.trial._state import TrialState

    # Enum checks must precede the int check: both enums are IntEnums, so
    # isinstance(x, int) is True for them and would strip the type tag.
    if isinstance(obj, StudyDirection):
        return {"__t": "dir", "v": int(obj)}
    if isinstance(obj, TrialState):
        return {"__t": "st", "v": int(obj)}
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        if math.isfinite(obj):
            return obj
        return {"__t": "f", "v": repr(obj)}  # 'nan' / 'inf' / '-inf'
    # numpy scalars (accepted by the old pickle wire) degrade to Python
    # scalars; import-free duck checks keep numpy optional here.
    if type(obj).__module__ == "numpy" and hasattr(obj, "item") and not hasattr(obj, "__len__"):
        return _enc(obj.item())
    if isinstance(obj, datetime.datetime):
        return {"__t": "dt", "v": obj.isoformat()}
    if isinstance(obj, BaseDistribution):
        return {"__t": "dist", "v": distribution_to_json(obj)}
    if isinstance(obj, FrozenTrial):
        return {
            "__t": "trial",
            "number": obj.number,
            "state": int(obj.state),
            "values": _enc(obj.values),
            "start": _enc(obj.datetime_start),
            "complete": _enc(obj.datetime_complete),
            "params": _enc(obj.params),
            "dists": {k: distribution_to_json(d) for k, d in obj.distributions.items()},
            "user": _enc(obj.user_attrs),
            "system": _enc(obj.system_attrs),
            "intermediate": [[k, _enc(v)] for k, v in obj.intermediate_values.items()],
            "id": obj._trial_id,
        }
    if isinstance(obj, FrozenStudy):
        return {
            "__t": "study",
            "name": obj.study_name,
            "directions": [int(d) for d in obj.directions],
            "user": _enc(obj.user_attrs),
            "system": _enc(obj.system_attrs),
            "id": obj._study_id,
        }
    if isinstance(obj, (list, tuple, set, frozenset)):
        items = [_enc(x) for x in obj]
        if isinstance(obj, list):
            return items
        kind = "tuple" if isinstance(obj, tuple) else "set"
        return {"__t": kind, "items": items}
    if isinstance(obj, dict):
        if all(isinstance(k, str) and k != "__t" for k in obj):
            return {k: _enc(v) for k, v in obj.items()}
        return {"__t": "map", "items": [[_enc(k), _enc(v)] for k, v in obj.items()]}
    raise TypeError(f"Cannot encode {type(obj).__name__} for the storage wire.")


def _dec(obj: Any) -> Any:
    from optuna_tpu_torch.study._frozen import FrozenStudy
    from optuna_tpu_torch.study._study_direction import StudyDirection
    from optuna_tpu_torch.trial._frozen import FrozenTrial
    from optuna_tpu_torch.trial._state import TrialState

    if isinstance(obj, list):
        return [_dec(x) for x in obj]
    if not isinstance(obj, dict):
        return obj
    tag = obj.get("__t")
    if tag is None:
        return {k: _dec(v) for k, v in obj.items()}
    if tag == "f":
        return float(obj["v"])
    if tag == "dir":
        return StudyDirection(obj["v"])
    if tag == "st":
        return TrialState(obj["v"])
    if tag == "dt":
        return datetime.datetime.fromisoformat(obj["v"])
    if tag == "dist":
        return json_to_distribution(obj["v"])
    if tag == "tuple":
        return tuple(_dec(x) for x in obj["items"])
    if tag == "set":
        return set(_dec(x) for x in obj["items"])
    if tag == "map":
        return {_dec(k): _dec(v) for k, v in obj["items"]}
    if tag == "trial":
        values = _dec(obj["values"])
        return FrozenTrial(
            number=obj["number"],
            state=TrialState(obj["state"]),
            value=None,
            values=values,
            datetime_start=_dec(obj["start"]),
            datetime_complete=_dec(obj["complete"]),
            params=_dec(obj["params"]),
            distributions={k: json_to_distribution(d) for k, d in obj["dists"].items()},
            user_attrs=_dec(obj["user"]),
            system_attrs=_dec(obj["system"]),
            intermediate_values={int(k): _dec(v) for k, v in obj["intermediate"]},
            trial_id=obj["id"],
        )
    if tag == "study":
        return FrozenStudy(
            study_name=obj["name"],
            direction=None,
            directions=[StudyDirection(d) for d in obj["directions"]],
            user_attrs=_dec(obj["user"]),
            system_attrs=_dec(obj["system"]),
            study_id=obj["id"],
        )
    if tag == "err":
        cls = _ERROR_TYPES.get(obj["cls"]) or _device_error_types().get(obj["cls"], RuntimeError)
        return cls(obj["msg"])
    raise WireVersionError(f"Unknown wire tag {tag!r}.")


def encode_request(method: str, args: tuple, kwargs: dict) -> bytes:
    return json.dumps(
        {"v": WIRE_VERSION, "m": method, "a": _enc(list(args)), "k": _enc(kwargs)},
        separators=(",", ":"),
    ).encode()


def decode_request(data: bytes) -> tuple[str, list, dict]:
    msg = json.loads(data)
    if not isinstance(msg, dict) or msg.get("v") != WIRE_VERSION:
        raise WireVersionError(
            f"Unsupported request wire version {msg.get('v') if isinstance(msg, dict) else '?'}"
            f" (server speaks v{WIRE_VERSION})."
        )
    return msg["m"], _dec(msg["a"]), _dec(msg["k"])


def encode_response(ok: bool, payload: Any) -> bytes:
    if not ok:
        payload = {"__t": "err", "cls": type(payload).__name__, "msg": str(payload)}
        body = payload
    else:
        body = _enc(payload)
    return json.dumps(
        {"v": WIRE_VERSION, "ok": ok, "p": body}, separators=(",", ":")
    ).encode()


def decode_response(data: bytes) -> tuple[bool, Any]:
    msg = json.loads(data)
    if not isinstance(msg, dict) or msg.get("v") != WIRE_VERSION:
        raise WireVersionError(
            f"Unsupported response wire version"
            f" {msg.get('v') if isinstance(msg, dict) else '?'}"
            f" (client speaks v{WIRE_VERSION})."
        )
    return msg["ok"], _dec(msg["p"])
