"""The serve tier's wire and request dispatcher against the reference's.

``optuna_tpu_torch.storages._grpc._service`` must put the reference's bytes
on the wire: the same call encodes to identical request and response bytes
in both packages (``FrozenTrial``, ``FrozenStudy``, distributions,
datetimes, inf/NaN, the enums, tuple/set/int-keyed maps, exceptions), and
each package decodes the other's. The dispatcher
(``server._make_dispatch``, the grpc-free body of the reference's
``_make_handler``) answers a request sequence with the bytes the reference's
handler answers, dedupes op tokens (a replayed create is one trial, a
failure is never cached, a retry racing its original waits for it) and
rejects garbage without raising.
"""

from __future__ import annotations

import datetime
import threading
import types

import pytest

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu.storages._grpc import _service as ref_wire
from optuna_tpu.storages._grpc.server import _make_handler as ref_make_handler
from optuna_tpu_torch.storages._grpc import _service as wire
from optuna_tpu_torch.storages._grpc.server import _make_dispatch

PKGS = {"ref": optuna_tpu, "port": optuna_tpu_torch}
WIRES = {"ref": ref_wire, "port": wire}


def _values(pkg) -> dict:
    """One value of every wire shape, built from ``pkg``'s own classes."""
    d = pkg.distributions
    when = datetime.datetime(2026, 1, 2, 3, 4, 5, 678901)
    trial = pkg.trial.FrozenTrial(
        number=3,
        state=pkg.trial.TrialState.COMPLETE,
        value=None,
        values=[1.5, float("-inf")],
        datetime_start=when,
        datetime_complete=when + datetime.timedelta(seconds=2),
        params={"x": 0.25, "c": "b", "n": 7},
        distributions={
            "x": d.FloatDistribution(0.0, 1.0),
            "c": d.CategoricalDistribution(["a", "b", None, 2.5]),
            "n": d.IntDistribution(1, 9, step=2),
        },
        user_attrs={"u": [1, "two", None]},
        system_attrs={"ckpt:op": "r0:c1:0", "t": (1, 2)},
        intermediate_values={0: float("nan"), 4: 0.5},
        trial_id=11,
    )
    study = pkg.study._frozen.FrozenStudy(
        study_name="s",
        direction=None,
        directions=[pkg.study.StudyDirection.MINIMIZE, pkg.study.StudyDirection.MAXIMIZE],
        user_attrs={"a": 1},
        system_attrs={"lease:study:0": {"owner": "hub-a", "epoch": 2}},
        study_id=4,
    )
    return {
        "primitives": [None, True, 0, -7, 2.5, "s", ""],
        "non_finite": [float("nan"), float("inf"), float("-inf")],
        "enums": [pkg.trial.TrialState.PRUNED, pkg.study.StudyDirection.MAXIMIZE],
        "datetime": when,
        "containers": {"t": (1, 2), "s": {3}, "m": {1: "a", (2, 3): "b"}},
        "distributions": [
            d.FloatDistribution(1e-5, 1.0, log=True),
            d.FloatDistribution(0.0, 1.0, step=0.125),
            d.IntDistribution(1, 64, log=True),
            d.CategoricalDistribution([None, 1, "x"]),
        ],
        "frozen_trial": trial,
        "frozen_study": study,
    }


CASES = sorted(_values(optuna_tpu))


@pytest.mark.parametrize("case", CASES)
def test_request_bytes_equal_the_references(case):
    args = {pkg: (_values(PKGS[pkg])[case],) for pkg in PKGS}
    got = {
        pkg: WIRES[pkg].encode_request("set_study_user_attr", (4, "k", *args[pkg]), {"x": args[pkg][0]})
        for pkg in PKGS
    }
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("case", CASES)
def test_response_bytes_equal_the_references(case):
    got = {pkg: WIRES[pkg].encode_response(True, _values(PKGS[pkg])[case]) for pkg in PKGS}
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("case", CASES)
def test_each_package_decodes_the_others_bytes(case, writer):
    reader = "port" if writer == "ref" else "ref"
    raw = WIRES[writer].encode_response(True, _values(PKGS[writer])[case])
    ok, decoded = WIRES[reader].decode_response(raw)
    assert ok
    # Re-encoding what was decoded gives the same bytes back: every field,
    # type tag and class crossed.
    assert WIRES[reader].encode_response(True, decoded) == raw
    want = _values(PKGS[reader])[case]
    if case == "frozen_trial":
        assert type(decoded) is type(want)
        assert decoded.params == want.params and decoded.number == want.number
        assert decoded.distributions == want.distributions
    elif case == "frozen_study":
        assert type(decoded) is type(want) and decoded.directions == want.directions


@pytest.mark.parametrize(
    "err",
    [
        KeyError("k"),
        ValueError("v"),
        TypeError("t"),
        NotImplementedError("n"),
        "DuplicatedStudyError",
        "UpdateFinishedTrialError",
        "StorageInternalError",
        "StaleLeaseError",
        "ZeroDivisionError",
    ],
)
def test_errors_cross_the_wire_by_name(err):
    def make(pkg):
        if not isinstance(err, str):
            return err
        if err == "ZeroDivisionError":
            return ZeroDivisionError("not allow-listed")
        if err == "StaleLeaseError":
            return pkg.exceptions.StaleLeaseError(3, held_epoch=1, fence_epoch=2, owner="hub-b")
        return getattr(pkg.exceptions, err)("m")

    raws = {name: WIRES[name].encode_response(False, make(PKGS[name])) for name in PKGS}
    assert raws["port"] == raws["ref"]
    ok, back = wire.decode_response(raws["ref"])
    assert not ok
    want = type(make(optuna_tpu_torch))
    if want is ZeroDivisionError:
        want = RuntimeError  # never an arbitrary class lookup
    # The message is the sender's ``str(err)`` (a KeyError's carries its quotes).
    assert type(back) is want and back.args == (str(make(optuna_tpu_torch)),)


@pytest.mark.parametrize("kind", ["KernelBuildError", "AcceleratorError"])
def test_device_faults_cross_the_wire_as_device_faults(kind):
    """A hub's kernel-build or card fault decodes in the port as its own
    type, which ``is_device_fault`` classifies (so no degradation boundary
    of the client contains it); the reference, which has no such type,
    decodes it as a ``RuntimeError`` carrying the message."""
    import torch

    from optuna_tpu_torch.ops.kernels._nvcc import KernelBuildError
    from optuna_tpu_torch.samplers._resilience import is_device_fault

    cls = KernelBuildError if kind == "KernelBuildError" else getattr(torch, "AcceleratorError", None)
    if cls is None:
        pytest.skip("this torch has no torch.AcceleratorError")
    raw = wire.encode_response(False, cls("nvcc failed on matern52_gram.cu"))
    ok, back = wire.decode_response(raw)
    assert not ok and type(back) is cls and back.args == ("nvcc failed on matern52_gram.cu",)
    assert is_device_fault(back)
    ok, ref_back = ref_wire.decode_response(raw)
    assert not ok and type(ref_back) is RuntimeError and str(ref_back) == "nvcc failed on matern52_gram.cu"


def test_wire_constants_and_method_sets_are_the_references():
    from optuna_tpu.storages._grpc import client as ref_client
    from optuna_tpu_torch.storages._grpc import client
    from optuna_tpu_torch.storages._retry import REPLAY_UNSAFE_METHODS

    for name in ("SERVICE_NAME", "WIRE_VERSION", "OP_TOKEN_KEY", "FLIGHT_CTX_KEY", "METHODS", "SUGGEST_METHODS"):
        assert getattr(wire, name) == getattr(ref_wire, name), name
    assert set(wire._ERROR_TYPES) == set(ref_wire._ERROR_TYPES)
    assert client._OP_TOKEN_METHODS == ref_client._OP_TOKEN_METHODS
    assert client._OP_TOKEN_METHODS <= REPLAY_UNSAFE_METHODS
    assert client.OP_TOKEN_REPLAY_WINDOW_S == ref_client.OP_TOKEN_REPLAY_WINDOW_S


@pytest.mark.parametrize("version", [0, 2, None])
def test_unknown_versions_are_rejected(version):
    import json

    raw = json.dumps({"v": version, "m": "get_all_studies", "a": [], "k": {}}).encode()
    with pytest.raises(wire.WireVersionError):
        wire.decode_request(raw)
    with pytest.raises(wire.WireVersionError):
        wire.decode_response(json.dumps({"v": version, "ok": True, "p": 1}).encode())
    with pytest.raises(wire.WireVersionError):
        wire._dec({"__t": "pickle", "v": "x"})


def test_unencodable_object_raises():
    with pytest.raises(TypeError):
        wire.encode_response(True, object())


# ---------------------------------------------------------------- dispatcher


def _ref_dispatch(storage):
    handler = ref_make_handler(storage)
    method_handler = handler.service(types.SimpleNamespace(method=f"/{ref_wire.SERVICE_NAME}/x"))
    return lambda raw: method_handler.unary_unary(raw, None)


def _script(pkg) -> list[bytes]:
    """One request sequence, encoded by ``pkg``: a study, trials (one
    create replayed under its token), params, a tell, reads, an app-level
    error, an unknown method and garbage."""
    w = WIRES[pkg.__name__ == "optuna_tpu" and "ref" or "port"]
    SD, TS, d = pkg.study.StudyDirection, pkg.trial.TrialState, pkg.distributions
    tok = {w.OP_TOKEN_KEY: "tok-1"}
    return [
        w.encode_request("create_new_study", ([SD.MINIMIZE], "s"), {w.OP_TOKEN_KEY: "tok-0"}),
        w.encode_request("create_new_trial", (0,), tok),
        w.encode_request("create_new_trial", (0,), tok),  # a replay: the same trial id
        w.encode_request("set_trial_param", (0, "x", 0.5, d.FloatDistribution(0.0, 1.0)), {}),
        w.encode_request("set_trial_state_values", (0, TS.COMPLETE, [0.25]), {w.OP_TOKEN_KEY: "tok-2"}),
        w.encode_request("get_trial_params", (0,), {}),
        w.encode_request("get_n_trials", (0,), {}),
        w.encode_request("get_study_id_from_name", ("missing",), {}),
        w.encode_request("no_such_method", (), {}),
        b"not json",
        w.encode_request("service_ask", (0, 0, 0), {}),  # no service mounted: unknown
    ]


def test_dispatcher_answers_a_script_with_the_references_bytes():
    ref = _ref_dispatch(optuna_tpu.storages.InMemoryStorage())
    port = _make_dispatch(optuna_tpu_torch.storages.InMemoryStorage())
    ref_script, port_script = _script(optuna_tpu), _script(optuna_tpu_torch)
    assert ref_script == port_script
    for raw in port_script:
        assert port(raw) == ref(raw), raw[:60]


def test_dispatcher_replays_a_token_as_one_trial_and_never_caches_failures():
    from optuna_tpu_torch import telemetry

    storage = optuna_tpu_torch.storages.InMemoryStorage()
    dispatch = _make_dispatch(storage)
    sid = storage.create_new_study([optuna_tpu_torch.study.StudyDirection.MINIMIZE])
    telemetry.enable(telemetry.MetricsRegistry())
    try:
        raw = wire.encode_request("create_new_trial", (sid,), {wire.OP_TOKEN_KEY: "t"})
        answers = [wire.decode_response(dispatch(raw)) for _ in range(3)]
        assert answers == [(True, 0)] * 3
        assert storage.get_n_trials(sid) == 1
        assert telemetry.snapshot()["counters"].get("grpc.op_token_dedup") == 2
        bad = wire.encode_request("set_trial_state_values", (99, 1, [1.0]), {wire.OP_TOKEN_KEY: "u"})
        first, second = wire.decode_response(dispatch(bad)), wire.decode_response(dispatch(bad))
        assert not first[0] and not second[0]
        assert telemetry.snapshot()["counters"].get("grpc.op_token_dedup") == 2
    finally:
        telemetry.disable()


def test_dispatcher_retry_racing_its_original_waits_for_it():
    """A retry arriving while its original still executes parks on the
    original and replays its answer: one execution."""
    storage = optuna_tpu_torch.storages.InMemoryStorage()
    sid = storage.create_new_study([optuna_tpu_torch.study.StudyDirection.MINIMIZE])
    entered, release = threading.Event(), threading.Event()
    calls = []

    class Slow(optuna_tpu_torch.storages._base._ForwardingStorage):
        def create_new_trial(self, study_id, template_trial=None):
            calls.append(study_id)
            entered.set()
            assert release.wait(timeout=30.0)
            return self._backend.create_new_trial(study_id, template_trial)

    dispatch = _make_dispatch(Slow(storage))
    raw = wire.encode_request("create_new_trial", (sid,), {wire.OP_TOKEN_KEY: "race"})
    out = {}
    first = threading.Thread(target=lambda: out.setdefault("first", dispatch(raw)))
    first.start()
    assert entered.wait(timeout=30.0)
    second = threading.Thread(target=lambda: out.setdefault("second", dispatch(raw)))
    second.start()
    release.set()
    first.join(timeout=30.0)
    second.join(timeout=30.0)
    assert not first.is_alive() and not second.is_alive()
    assert out["first"] == out["second"] and len(calls) == 1
    assert storage.get_n_trials(sid) == 1


def test_dispatcher_strips_wire_kwargs_and_defaults_heartbeats():
    class NoHeartbeat(optuna_tpu_torch.storages._base._ForwardingStorage):
        pass

    storage = NoHeartbeat(optuna_tpu_torch.storages.InMemoryStorage())
    dispatch = _make_dispatch(storage)
    ok, sid = wire.decode_response(
        dispatch(wire.encode_request("create_new_study", ([1],), {wire.FLIGHT_CTX_KEY: {"t": "a", "s": "b"}}))
    )
    assert ok and sid == 0
    assert wire.decode_response(dispatch(wire.encode_request("get_failed_trial_callback", (), {}))) == (True, None)
