"""The port's sharded tier against the reference's, on the CPU.

Both packages run in this process for the one-rank cases (the reference on
the 8 forced CPU devices of ``tests/conftest.py``); the multi-rank cases run
in spawned gloo ranks (``tests/_torch_mesh_workers.py``: one spawn of 2
ranks and one of 2 x 2 for the whole module, every scenario inside) and are
held to the reference's runs here:

- the partition rules: the port's specs equal the reference's
  ``PartitionSpec`` s as tuples on one nested tree; an unmatched leaf raises
  in both; the shard and gather round trip is exact on a 2 x 2 mesh, and
  ``w1``'s local shard is ``(8, 8)`` on every model rank (the guard against
  a silent replication);
- the degenerate mesh: ``RandomSampler(seed=11)`` (host NumPy draws, so the
  params are bit for bit across packages) at 1 x 1 in this process and at
  ``{'trials': 2, 'model': 1}`` on two ranks (one logical study on an
  in-memory storage; the lockstep pod on the ICI journal), the reference at
  ``{'trials': 8, 'model': 1}``: params, states and best value equal, values
  within ``VALUE_RTOL`` (float32 in both);
- the sharded MLP of ``tests/test_sharded.py``: the port at 2 x 2, the
  reference at ``{'trials': 4, 'model': 2}``, values within ``MLP_RTOL``;
- the reference's containment, kill/reap, chaos and imbalance cases
  (``tests/test_sharded.py:252-415, 596-690``) at the geometry two worker
  ranks of this machine afford, ``{'trials': 2, 'model': 2}`` and batches
  of 4 (``ShardChaosPlan(mesh_trials=2, mesh_model=2, batch_size=4)``,
  still two rows a shard);
- a failure on one rank only (a poison row, a hung evaluation under a
  deadline, an out-of-memory error, a device fault, a failed upload) is one
  verdict on every rank, within the group's timeout, and a follower rank
  passes over only such agreed errors;
- the pod's lockstep through the ``FakePodBus`` threads and for real.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import pytest
import torch

import optuna_tpu
import optuna_tpu_torch
from optuna_tpu_torch import health, telemetry
from optuna_tpu_torch.distributions import FloatDistribution
from optuna_tpu_torch.parallel import (
    IciJournalBackend,
    PodFollowerStorage,
    ShardedObjective,
    VectorizedObjective,
    build_study_mesh,
    match_partition_rules,
    mesh_worker_id,
    optimize_sharded,
    optimize_vectorized,
)
from optuna_tpu_torch.parallel._mesh import ShardDispatchError
from optuna_tpu_torch.parallel.executor import DispatchTimeoutError, ResilientBatchExecutor
from optuna_tpu_torch.samplers import RandomSampler, TPESampler
from optuna_tpu_torch.storages.journal import JournalStorage
from optuna_tpu_torch.testing.fault_injection import FakePodBus, ShardChaosPlan, shard_chaos_plan
from optuna_tpu_torch.trial._state import TrialState
from tests import _torch_mesh_workers as workers
from tests._torch_port import cuda_device, one_torch_thread  # noqa: F401  (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VALUE_RTOL = 1e-6  # float32 objective values from the same float32 inputs
MLP_RTOL = 1e-5  # the sharded MLP: float32 matmuls, summed in another order across the model shards
SPACE = {"x": FloatDistribution(0.0, 1.0)}

for _pkg in (optuna_tpu, optuna_tpu_torch):
    _pkg.logging.set_verbosity(_pkg.logging.ERROR)


def _quad(params):
    return (params["x"] - 0.3) ** 2


def _states(study) -> dict:
    return {s: sum(t.state == s for t in study.trials) for s in TrialState}


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    telemetry.enable(telemetry.MetricsRegistry())
    yield
    telemetry.disable()


@pytest.fixture(scope="module")
def mesh_1x1():
    return build_study_mesh({"trials": 1, "model": 1}, device="cpu")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return workers.spawn_ranks("two", 2, tmp_path_factory.mktemp("two"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return workers.spawn_ranks("four", 4, tmp_path_factory.mktemp("four"))


def _ref_quad(params):
    return (params["x"] - 0.3) ** 2


def _ref_study(storage_kind: str, seed: int):
    from optuna_tpu.parallel import IciJournalBackend as RefBackend
    from optuna_tpu.storages.journal import JournalStorage as RefJournal

    storage = None if storage_kind == "in_memory" else RefJournal(RefBackend())
    return optuna_tpu.create_study(storage=storage, sampler=optuna_tpu.samplers.RandomSampler(seed=seed))


def _ref_degenerate(storage_kind: str):
    from optuna_tpu.distributions import FloatDistribution as RefFloat
    from optuna_tpu.parallel import VectorizedObjective as RefObjective
    from optuna_tpu.parallel import optimize_sharded as ref_optimize_sharded

    study = _ref_study(storage_kind, 11)
    ref_optimize_sharded(
        study,
        RefObjective(_ref_quad, {"x": RefFloat(0.0, 1.0)}),
        n_trials=20,
        batch_size=8,
        mesh_shape={"trials": 8, "model": 1},
    )
    return [(t.number, dict(t.params), t.state.name, t.values) for t in study.trials], study.best_value


def _assert_rows_match(port_rows, ref_rows):
    assert len(port_rows) == len(ref_rows) == 20
    for (n, params, state, values), (rn, rparams, rstate, rvalues) in zip(port_rows, ref_rows):
        assert (n, params, state) == (rn, rparams, rstate)
        np.testing.assert_allclose(values, rvalues, rtol=VALUE_RTOL)


# ------------------------------------------------------------ partition rules


class _Pair(NamedTuple):
    a: np.ndarray
    b: np.ndarray


def _rules_tree():
    return {
        "encoder": {"w1": np.zeros((4, 8)), "bias": np.zeros(8)},
        "head": np.zeros((8, 2)),
        "temperature": np.float32(1.0),
        "layers": [np.zeros((2, 4)), np.zeros(4)],
        "pair": _Pair(np.zeros((3, 3)), np.zeros((1,))),
    }


_RULES = [
    ("encoder/w1", (None, "model")),
    ("bias", ("model",)),
    ("layers/0", ("model", None)),
    ("layers/1", ("model",)),
    ("pair/a", (None, "model")),
    (".*", ()),
]


def test_partition_specs_equal_the_references():
    from jax.sharding import PartitionSpec as P

    from optuna_tpu.parallel import match_partition_rules as ref_match

    port = match_partition_rules(_RULES, _rules_tree())
    ref = ref_match([(pattern, P(*spec)) for pattern, spec in _RULES], _rules_tree())
    assert port["encoder"] == {k: tuple(v) for k, v in ref["encoder"].items()}
    assert port["head"] == tuple(ref["head"]) == ()
    assert port["temperature"] == tuple(ref["temperature"]) == ()  # scalars replicate before any rule
    assert port["layers"] == [tuple(s) for s in ref["layers"]] == [("model", None), ("model",)]
    assert isinstance(port["pair"], _Pair)
    assert tuple(port["pair"]) == tuple(tuple(s) for s in ref["pair"]) == ((None, "model"), ())


def test_an_unmatched_leaf_raises_in_both_packages():
    from jax.sharding import PartitionSpec as P

    from optuna_tpu.parallel import match_partition_rules as ref_match

    with pytest.raises(ValueError, match="no partition rule matched.*head"):
        ref_match([("encoder", P("model"))], {"head": np.zeros((4, 4))})
    with pytest.raises(ValueError, match="no partition rule matched.*head"):
        match_partition_rules([("encoder", ("model",))], {"head": np.zeros((4, 4))})


def test_build_study_mesh_validates(mesh_1x1):
    with pytest.raises(ValueError, match="unknown mesh axes"):
        build_study_mesh({"trials": 2, "layers": 2}, device="cpu")
    with pytest.raises(ValueError, match="needs 64 ranks; only 1 available"):
        build_study_mesh({"trials": 32, "model": 2}, device="cpu")
    assert dict(zip(mesh_1x1.mesh_dim_names, mesh_1x1.shape)) == {"trials": 1, "model": 1}
    assert mesh_1x1.device_type == "cpu"
    default = build_study_mesh(device="cpu")
    assert dict(zip(default.mesh_dim_names, default.shape)) == {"trials": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            build_study_mesh({"trials": 1, "model": 1})


def test_mesh_worker_id_carries_mesh_coordinates(mesh_1x1):
    from optuna_tpu.parallel import build_study_mesh as ref_mesh
    from optuna_tpu.parallel import mesh_worker_id as ref_worker_id

    worker = mesh_worker_id(mesh_1x1)
    assert worker == f"{health.default_worker_id()}-t0m0"
    assert ref_worker_id(ref_mesh({"trials": 4, "model": 2})).endswith("-t0m0")


def test_sharded_objective_without_mesh_is_rejected_in_both_packages():
    from optuna_tpu.parallel import ShardedObjective as RefSharded

    model, _ = workers.mlp_model_and_x()
    with pytest.raises(ValueError, match="needs a mesh"):
        RefSharded(lambda p, m: p, {}, model=model, partition_rules=[(".*", None)]).guarded(None, "trials")
    with pytest.raises(ValueError, match="needs a mesh"):
        ShardedObjective(lambda p, m: p, {}, model=model, partition_rules=[(".*", None)]).guarded(None, "trials")


# ----------------------------------------------------- degenerate-mesh parity


@pytest.mark.parametrize("storage_kind", ["in_memory", "ici_journal"])
def test_degenerate_mesh_matches_the_reference_and_optimize_vectorized(storage_kind, mesh_1x1):
    def make_study():
        storage = None if storage_kind == "in_memory" else JournalStorage(IciJournalBackend())
        return optuna_tpu_torch.create_study(storage=storage, sampler=RandomSampler(seed=11))

    sharded = make_study()
    optimize_sharded(sharded, VectorizedObjective(_quad, SPACE), n_trials=20, batch_size=8, mesh=mesh_1x1)
    plain = make_study()
    optimize_vectorized(plain, VectorizedObjective(_quad, SPACE), n_trials=20, batch_size=8, device="cpu")
    rows = [(t.number, dict(t.params), t.state.name, t.values) for t in sharded.trials]
    assert rows == [(t.number, dict(t.params), t.state.name, t.values) for t in plain.trials]
    ref_rows, ref_best = _ref_degenerate(storage_kind)
    _assert_rows_match(rows, ref_rows)
    assert sharded.best_value == pytest.approx(ref_best, rel=VALUE_RTOL)


@pytest.mark.parametrize("storage_kind", ["in_memory", "ici_journal"])
def test_two_rank_degenerate_mesh_matches_the_reference(storage_kind, two_ranks):
    scenario = f"degenerate_{storage_kind}"
    lead = workers.result(two_ranks, scenario, 0)
    other = workers.result(two_ranks, scenario, 1)
    ref_rows, ref_best = _ref_degenerate(storage_kind)
    _assert_rows_match(lead["rows"], ref_rows)
    assert lead["best"] == pytest.approx(ref_best, rel=VALUE_RTOL)
    if storage_kind == "in_memory":
        # One logical study: rank 1 evaluated every dispatch rank 0 made.
        assert other["dispatches"] == lead["dispatches"] == 3
    else:
        # The pod: both ranks derive the same study from the same merged log.
        assert other["rows"] == lead["rows"]
        assert other["logs"] == lead["logs"]
        assert lead["exchanges"] == other["exchanges"] == 3  # one barrier a batch
        assert lead["suppressed_restored"] and other["suppressed_restored"]


def test_a_poison_row_on_one_rank_fails_only_its_trial_on_every_rank(two_ranks):
    lead = workers.result(two_ranks, "poison_row_on_one_rank", 0)
    other = workers.result(two_ranks, "poison_row_on_one_rank", 1)
    failed = [(n, p) for n, p, state, _ in lead["rows"] if state == "FAIL"]
    assert failed == [(0, {"x": 0.99})]
    assert all(state == "COMPLETE" for n, _, state, _ in lead["rows"] if n != 0)
    # Every re-dispatch reached both ranks, in step, well inside the timeout.
    assert other["dispatches"] == lead["dispatches"] > 2
    assert max(lead["seconds"], other["seconds"]) < workers.PG_TIMEOUT_S


def test_a_deadline_on_one_rank_is_one_verdict_on_every_rank(two_ranks):
    lead = workers.result(two_ranks, "deadline_on_one_rank", 0)
    other = workers.result(two_ranks, "deadline_on_one_rank", 1)
    assert lead["error"] is None and other["error"] is None
    assert lead["timeouts"] >= 1
    assert other["dispatches"] == lead["dispatches"]
    assert [n for n, _, state, _ in lead["rows"] if state != "COMPLETE"] == [0]


def test_an_oom_on_one_rank_halves_on_every_rank_down_to_a_row_a_shard(two_ranks):
    lead = workers.result(two_ranks, "oom_on_one_rank", 0)
    other = workers.result(two_ranks, "oom_on_one_rank", 1)
    assert lead["states"] == {"COMPLETE": 8}
    # 8 (4 rows a rank) and both halves of 4 (2 rows) ran out of memory; the
    # dispatches of 2 (one row a rank) fit: 8, 4, 2, 2, 4, 2, 2 on both.
    assert lead["halvings"] == 3
    assert lead["dispatches"] == other["dispatches"] == 7


def test_a_device_fault_on_one_rank_is_re_raised_on_every_rank(two_ranks):
    lead = workers.result(two_ranks, "device_fault_on_one_rank", 0)
    other = workers.result(two_ranks, "device_fault_on_one_rank", 1)
    assert lead["error"].startswith("ShardDeviceFault") and "illegal memory access" in lead["error"]
    assert other["error"].startswith("RuntimeError: rank 0's run ended with ShardDeviceFault")
    assert lead["states"] == {"FAIL": 4}  # the batch FAILed, never bisected, nothing RUNNING


def test_a_failed_upload_on_one_rank_is_one_verdict_on_every_rank(two_ranks):
    lead = workers.result(two_ranks, "upload_fault_on_one_rank", 0)
    other = workers.result(two_ranks, "upload_fault_on_one_rank", 1)
    assert lead["states"] == {"COMPLETE": 8}
    # The first batch's dispatch failed on both ranks and split along its two
    # shard groups; both groups and the second batch ran: 4 dispatches each.
    assert lead["bisections"] == 1
    assert lead["dispatches"] == other["dispatches"] == 4


@pytest.mark.parametrize(
    "error, passed_over",
    [
        (ShardDispatchError("shard t1m0 (error): RuntimeError: poison"), True),
        (torch.OutOfMemoryError("out of memory on the mesh"), True),
        (DispatchTimeoutError("rows of trials shard 1"), True),
        (RuntimeError("pinned copy failed"), False),
    ],
    ids=["agreed", "oom", "timeout", "other"],
)
def test_a_follower_passes_over_only_the_agreed_errors(monkeypatch, error, passed_over):
    """An error the gather agreed on is rank 0's to contain, and the
    follower waits for its next dispatch; any other error means the ranks
    left step, and the follower raises it."""
    from types import SimpleNamespace

    from optuna_tpu_torch.parallel import _mesh

    messages = iter([("batch", {"x": np.zeros(2, np.float32)}), ("stop", None)])
    monkeypatch.setattr(_mesh, "receive", lambda: next(messages))

    def dispatch(packed):
        raise error

    follower = SimpleNamespace(_dispatch=dispatch)
    if passed_over:
        ResilientBatchExecutor._follow(follower)
        assert next(messages, None) is None  # it went on to the stop
    else:
        with pytest.raises(RuntimeError, match="pinned copy failed"):
            ResilientBatchExecutor._follow(follower)


# ------------------------------------------------------------- sharded model


def test_shard_and_gather_round_trip_is_exact_on_a_2x2_mesh(four_ranks):
    expect = np.arange(32, dtype=np.float32).reshape(4, 8)
    coords = []
    for rank in range(4):
        out = workers.result(four_ranks, "rules_round_trip", rank)
        np.testing.assert_array_equal(out["w"], expect)
        assert out["s"] == 3.0
        assert out["local_w"] == (4, 4) and out["placements"] == ["R", "S(1)"]
        coords.append(tuple(out["coordinate"]))
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_w1_local_shard_guards_against_silent_replication(four_ranks):
    for rank in range(4):
        out = workers.result(four_ranks, "sharded_mlp", rank)
        assert out["local"] == {"w1": (8, 8), "b1": (8,), "w2": (8, 4), "temperature": ()}
        assert out["placements"]["w1"] == ["R", "S(1)"]
        assert out["w1_round_trip"]


def test_sharded_mlp_values_match_the_reference(four_ranks):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from optuna_tpu.distributions import FloatDistribution as RefFloat
    from optuna_tpu.parallel import ShardedObjective as RefSharded
    from optuna_tpu.parallel import build_study_mesh as ref_mesh

    model, x_np = workers.mlp_model_and_x()
    x = jnp.asarray(x_np)

    def fn(params, m):
        import jax

        def one(lr, scale):
            h = jnp.maximum(x @ (m["w1"] * scale) + m["b1"], 0.0)
            out = h @ m["w2"] / m["temperature"]
            return jnp.mean(out**2) * lr

        return jax.vmap(one)(params["lr"], params["scale"])

    space = {"lr": RefFloat(0.01, 1.0, log=True), "scale": RefFloat(0.5, 2.0)}
    ref = RefSharded(fn, space, model=model, partition_rules=[(k, P(*s)) for k, s in workers.MLP_RULES])
    batch = workers.mlp_params_batch()
    ref_values, _ = ref.guarded(ref_mesh({"trials": 4, "model": 2}), "trials")({k: jnp.asarray(v) for k, v in batch.items()})
    for rank in range(4):
        out = workers.result(four_ranks, "sharded_mlp", rank)
        assert out["finite"].all()
        np.testing.assert_allclose(out["values"], np.asarray(ref_values), rtol=MLP_RTOL)


def test_sharded_objective_runs_the_model_axis(four_ranks):
    out = workers.result(four_ranks, "sharded_mlp", 0)
    assert out["states"] == {"COMPLETE": 16}
    assert out["all_finite"]


def test_a_dtensor_mlp_on_a_one_rank_mesh_equals_its_plain_twin(mesh_1x1):
    """``models.mlp.train_scaled_batch`` with ``cross_entropy_onehot`` on the
    rules' DTensors equals the same function on plain tensors bit for bit:
    on one rank every DTensor op is the local op (phase 36(a)'s contract, at
    a small size)."""
    from torch.distributed.tensor import DTensor, Replicate

    from optuna_tpu_torch.models.mlp import MLPParams, cross_entropy_onehot, mlp_params_from_numpy, train_scaled_batch

    rng = np.random.RandomState(0)
    init = {
        "w1": rng.normal(0, 0.1, (24, 8)).astype(np.float32),
        "b1": np.zeros(8, np.float32),
        "w2": rng.normal(0, 0.1, (8, 3)).astype(np.float32),
        "b2": np.zeros(3, np.float32),
    }
    x = torch.from_numpy(rng.normal(size=(16, 24)).astype(np.float32))
    onehot = torch.eye(3)[torch.from_numpy(rng.randint(0, 3, 16))]

    def sharded(params, m):
        rep = [Replicate()] * m["w1"].device_mesh.ndim
        dx, doh = (DTensor.from_local(t, m["w1"].device_mesh, rep, run_check=False) for t in (x, onehot))
        model = MLPParams(m["w1"], m["b1"], m["w2"], m["b2"])
        return train_scaled_batch(model, dx, doh, params["lr"], params["init_scale"], 3, cross_entropy_onehot)

    space = {"lr": FloatDistribution(1e-3, 1.0, log=True), "init_scale": FloatDistribution(0.3, 3.0)}
    rules = [("w1", (None, "model")), ("b1", ("model",)), ("w2", ("model", None)), (".*", ())]
    obj = ShardedObjective(sharded, space, model=init, partition_rules=rules)
    args = {"lr": torch.tensor([0.5, 0.05, 0.9], dtype=torch.float32), "init_scale": torch.tensor([0.5, 1.0, 2.5])}
    values, finite = obj.guarded(mesh_1x1, "trials")(args)
    plain = train_scaled_batch(
        mlp_params_from_numpy(init, "cpu"), x, onehot, args["lr"], args["init_scale"], 3, cross_entropy_onehot
    )
    assert finite.all()
    assert torch.equal(values, plain)
    placed, specs = obj.sharded_model(mesh_1x1)
    assert specs["b2"] == () and tuple(placed["w1"].to_local().shape) == (24, 8)


# ------------------------------------------------------ per-shard containment


def test_transient_crash_splits_along_shard_groups(four_ranks):
    lead = workers.result(four_ranks, "transient_crash", 0)
    assert lead["states"] == {"COMPLETE": 4}
    # One full-width dispatch, then one re-dispatch a shard group (each
    # 2-trial group padded to the 2-shard multiple), on every rank alike.
    for rank in range(4):
        assert workers.result(four_ranks, "transient_crash", rank)["widths"] == [4, 2, 2]
    assert lead["counters"]["executor.bisection"] == 1
    assert lead["gauges"]["device.shard.contained_groups.total"] == 2.0


def test_poison_trial_fails_only_its_shard_slots(four_ranks):
    rows = workers.result(four_ranks, "poison_trial", 0)["rows"]
    assert not any(state == "RUNNING" for _, _, state, _ in rows)
    failed = [params["x"] for _, params, state, _ in rows if state == "FAIL"]
    assert failed == [0.99]
    complete = [params["x"] for _, params, state, _ in rows if state == "COMPLETE"]
    assert len(complete) == 7 and all(x <= 0.97 for x in complete)


def test_nan_slots_quarantine_per_slot_and_report_shard_stats(four_ranks):
    plan = ShardChaosPlan(mesh_trials=2, mesh_model=2, batch_size=4, n_trials=12)
    out = workers.result(four_ranks, "nan_slots", 0)["fail"]
    assert out["states"] == {"FAIL": plan.expected_quarantined, "COMPLETE": plan.batch_size - plan.expected_quarantined}
    assert out["gauges"]["device.shard.width.last"] == plan.batch_size / plan.mesh_trials
    assert out["gauges"]["device.shard.quarantined.total"] == float(plan.expected_quarantined)
    assert out["counters"]["executor.quarantine"] == plan.expected_quarantined
    # Both NaN rows are shard t0's: its throughput gauge is short by both.
    assert out["gauges"]["shard.trials.t0.total"] == 0.0
    assert out["gauges"]["shard.trials.t1.total"] == 2.0


def test_clip_policy_quarantines_nothing_and_counts_full_throughput(four_ranks):
    plan = ShardChaosPlan(mesh_trials=2, mesh_model=2, batch_size=4, n_trials=12)
    out = workers.result(four_ranks, "nan_slots", 0)["clip"]
    assert out["states"] == {"COMPLETE": plan.batch_size}
    assert out["gauges"].get("device.shard.quarantined.total", 0.0) == 0.0
    assert "executor.quarantine" not in out["counters"]
    for k in range(plan.mesh_trials):
        assert out["gauges"][f"shard.trials.t{k}.total"] == float(plan.batch_size // plan.mesh_trials)


def test_fully_quarantined_shard_registers_zero_throughput_gauge(four_ranks):
    out = workers.result(four_ranks, "fully_quarantined_shard", 0)
    assert out["gauges"]["shard.trials.t0.total"] == 0.0  # present, and zero
    assert out["gauges"]["shard.trials.t1.total"] == 6.0


def test_fault_free_twin_reports_zero_shard_faults(four_ranks):
    out = workers.result(four_ranks, "fault_free_twin", 0)
    assert out["gauges"].get("device.shard.quarantined.total", 0.0) == 0.0
    assert "device.shard.contained_groups.total" not in out["gauges"]
    assert not any(name.startswith(("executor.", "heartbeat.")) for name in out["counters"])


# ------------------------------------------------------- heartbeat reap (mesh)


def test_mesh_path_kill_reap_and_drain_converges_exactly(four_ranks):
    """Every rank dies at dispatch 1 (the kit kills them at once); rank 0's
    sqlite study (heartbeats) is reaped, the clones re-enqueue with lineage
    and without ``batch_exec:`` attrs, and the drained study equals the
    fault-free run."""
    out = workers.result(four_ranks, "kill_reap_drain", 0)
    assert all(workers.result(four_ranks, "kill_reap_drain", r)["died"] for r in range(4))
    assert out["running_after_death"] == 4
    assert out["clones"] == 4 and out["clones_clean"] and out["clones_lineage"]
    assert out["final"].get("RUNNING", 0) == 0
    assert out["final"]["COMPLETE"] == 8
    assert out["values"] == out["clean_values"]
    assert out["best"] == out["clean_best"]


def test_chaos_acceptance_at_2x2(four_ranks):
    """NaN rows on shard t0 and a killed worker in one study: the doctor
    reports ``worker.dead`` at the mesh coordinate, the dead batch and the
    quarantined rows re-enqueue, every healthy trial COMPLETEs exactly once,
    zero RUNNING, and the fault-free twin is containment-free."""
    plan = ShardChaosPlan(mesh_trials=2, mesh_model=2, batch_size=4, n_trials=12)
    out = workers.result(four_ranks, "chaos_acceptance", 0)
    assert all(workers.result(four_ranks, "chaos_acceptance", r)["died"] for r in range(4))
    assert out["clean_states"] == {"COMPLETE": plan.n_trials}
    assert not any(name.startswith(("executor.", "heartbeat.", "sampler.fallback")) for name in out["clean_counters"])
    assert out["running_after_reap"] == 0
    for check in plan.expected_findings:
        assert check in out["findings"]
    dead = out["findings"]["worker.dead"]
    assert plan.dead_worker_id in dead["evidence"]["dead_workers"]
    assert plan.dead_worker_coord in dead["summary"]
    assert out["waiting"] == plan.batch_size + plan.expected_quarantined
    assert out["final"].get("RUNNING", 0) == 0
    assert out["final"]["COMPLETE"] == plan.n_trials
    assert out["final_params"] == out["clean_params"]
    assert out["best"] == out["clean_best"]


def test_shard_chaos_plan_equals_the_references():
    from optuna_tpu.testing.fault_injection import shard_chaos_plan as ref_plan

    port, ref = shard_chaos_plan(), ref_plan()
    fields = ("mesh_trials", "mesh_model", "batch_size", "n_trials", "kill_dispatch", "dead_worker_coord",
              "dead_worker_age_s", "expected_findings", "expected_quarantined", "dead_worker_id")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert dict(port.nan_slots) == dict(ref.nan_slots)


# -------------------------------------------------------- doctor: imbalance


def _fleet_with_shard_gauges(gauges):
    return {"workers": [], "n_workers": 1, "n_alive": 1, "counters": {}, "gauges": gauges, "histograms": {}, "jit": {}}


def _diagnose_both(gauges):
    fleet = _fleet_with_shard_gauges(gauges)
    port = health.diagnose(fleet, [], [optuna_tpu_torch.study.StudyDirection.MINIMIZE])
    ref = optuna_tpu.health.diagnose(fleet, [], [optuna_tpu.study.StudyDirection.MINIMIZE])
    assert [(f.check, f.severity, f.summary, f.evidence) for f in port] == [
        (f.check, f.severity, f.summary, f.evidence) for f in ref
    ]
    return port


def test_shard_imbalance_check_fires_on_lagging_shard():
    findings = _diagnose_both({"shard.trials.t0.total": 24.0, "shard.trials.t1.total": 26.0,
                               "shard.trials.t2.total": 8.0, "shard.trials.t3.total": 25.0})
    assert [f.check for f in findings] == ["shard.imbalance"]
    assert findings[0].severity == "WARNING"
    assert findings[0].evidence["lagging_shards"] == ["t2"]


def test_shard_imbalance_sees_majority_dead_shards():
    findings = _diagnose_both({"shard.trials.t0.total": 100.0, "shard.trials.t1.total": 0.0,
                               "shard.trials.t2.total": 0.0, "shard.trials.t3.total": 0.0})
    assert findings[0].evidence["lagging_shards"] == ["t1", "t2", "t3"]


def test_shard_imbalance_stays_clean_when_balanced_or_sparse():
    assert not _diagnose_both({f"shard.trials.t{k}.total": 24.0 + k for k in range(4)})
    assert not _diagnose_both({"shard.trials.t0.total": 4.0, "shard.trials.t1.total": 1.0})


def test_shard_imbalance_flows_through_published_snapshots():
    clock = {"t": 0.0}
    health.enable(interval_s=0.0, worker_id="host-1-t0m0", clock=lambda: clock["t"], now=lambda: 1000.0 + clock["t"])
    try:
        study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
        health.attach(study)
        for k, n in enumerate((30.0, 31.0, 29.0, 5.0)):
            telemetry.add_gauge(f"shard.trials.t{k}.total", n)
        snapshot = study.__dict__["_health_reporter"].publish()
        assert snapshot is not None and snapshot["gauges"]["shard.trials.t3.total"] == 5.0
        report = study.health_report(now=1001.0)
        assert "shard.imbalance" in {f["check"] for f in report["findings"]}
    finally:
        health.disable()


def test_sharded_loop_attaches_mesh_worker_id(mesh_1x1):
    clock = {"t": 0.0}
    health.enable(interval_s=0.0, clock=lambda: clock["t"], now=lambda: 1000.0 + clock["t"])
    try:
        study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
        optimize_sharded(study, VectorizedObjective(_quad, SPACE), n_trials=4, batch_size=4, mesh=mesh_1x1)
        workers_seen = health.worker_snapshots(study._storage, study._study_id)
        assert list(workers_seen) == [mesh_worker_id(mesh_1x1)]
    finally:
        health.disable()


# ----------------------------------------------------- pod lockstep (FakePodBus)


def test_fakepod_lockstep_surfaces_root_fault_not_barrier_symptom():
    bus = FakePodBus(2)

    def broken():
        raise RuntimeError("injected worker-1 fault")

    with pytest.raises(RuntimeError, match="injected worker-1 fault"):
        bus.lockstep(lambda: bus.workers[0].exchange(), broken)


def test_follower_storage_accepts_decorated_journal():
    from optuna_tpu_torch.storages._retry import RetryingStorage

    journal = JournalStorage(IciJournalBackend())
    assert PodFollowerStorage(RetryingStorage(journal))._journal is journal


def test_follower_storage_rejects_non_ici_backends():
    with pytest.raises(ValueError, match="IciJournalBackend"):
        PodFollowerStorage(optuna_tpu_torch.storages.InMemoryStorage())


def test_follower_zero_width_create_paces_no_exchange():
    journal = JournalStorage(IciJournalBackend())
    sid = journal.create_new_study([optuna_tpu_torch.study.StudyDirection.MINIMIZE], study_name="zero-width")
    follower = PodFollowerStorage(journal)

    def explode():
        raise AssertionError("zero-width create must not exchange")

    follower._ici.exchange = explode
    assert follower.create_new_trials(sid, 0) == []


def _lockstep_pod(pkg, bus_cls, run):
    bus = bus_cls(2)
    stores = [pkg.storages.journal.JournalStorage(w) for w in bus.workers]
    MIN = pkg.study.StudyDirection.MINIMIZE
    sid, _ = bus.lockstep(
        lambda: stores[0].create_new_study([MIN], study_name="pod"), lambda: bus.workers[1].exchange()
    )
    studies = [
        pkg.load_study(study_name="pod", storage=s, sampler=pkg.samplers.RandomSampler(seed=5)) for s in stores
    ]
    studies[1]._storage = pkg.parallel.PodFollowerStorage(stores[1])
    bus.lockstep(lambda: run(studies[0]), lambda: run(studies[1]))
    assert bus.workers[0].read_logs(0) == bus.workers[1].read_logs(0)
    trials = [s.get_all_trials(sid) for s in stores]
    assert len(trials[0]) == len(trials[1]) == 8
    for a, b in zip(*trials):
        assert (a.params, a.state, a.values) == (b.params, b.state, b.values)
        assert a.state == pkg.trial.TrialState.COMPLETE
    return [(t.number, t.params, t.values) for t in trials[0]]


def test_pod_lockstep_leader_follower_derive_identical_study(mesh_1x1):
    """Two ranks on the ``FakePodBus`` run the same ``optimize_sharded`` loop
    in lockstep (rank 0 leads the writes; rank 1's are mirrored by
    ``PodFollowerStorage``), in both packages: each package's ranks derive
    identical journals and studies, and the two packages the same trials."""
    from optuna_tpu.parallel import VectorizedObjective as RefObjective
    from optuna_tpu.testing.fault_injection import FakePodBus as RefBus

    def port_run(study):
        optimize_sharded(study, VectorizedObjective(_quad, SPACE), n_trials=8, batch_size=4, mesh=mesh_1x1)

    def ref_run(study):
        optuna_tpu.parallel.optimize_sharded(
            study, RefObjective(_ref_quad, {"x": optuna_tpu.distributions.FloatDistribution(0.0, 1.0)}),
            n_trials=8, batch_size=4, mesh_shape={"trials": 4, "model": 1},
        )

    port = _lockstep_pod(optuna_tpu_torch, FakePodBus, port_run)
    # The batch-boundary exchanges were spanned under shard.exchange (2
    # batches a rank).
    hist = telemetry.snapshot()["histograms"].get("phase.shard.exchange")
    assert hist is not None and hist["count"] >= 4
    ref = _lockstep_pod(optuna_tpu, RefBus, ref_run)
    assert [(n, p) for n, p, _ in port] == [(n, p) for n, p, _ in ref]
    for (_, _, v), (_, _, rv) in zip(port, ref):
        np.testing.assert_allclose(v, rv, rtol=VALUE_RTOL)


def test_health_suppress_skips_publishes_while_enabled():
    health.enable(interval_s=0.0)
    try:
        study = optuna_tpu_torch.create_study(sampler=RandomSampler(seed=0))
        health.suppress(study)
        health.attach(study)  # must not resurrect a reporter
        health.maybe_report(study)
        health.flush(study)
        assert health.worker_snapshots(study._storage, study._study_id) == {}
        study.__dict__.pop("_health_reporter")
        health.maybe_report(study)
        assert len(health.worker_snapshots(study._storage, study._study_id)) == 1
    finally:
        health.disable()


def test_study_optimize_sharded_is_the_front_door(mesh_1x1):
    study = optuna_tpu_torch.create_study(sampler=TPESampler(seed=3, device="cpu"))
    study.optimize_sharded(VectorizedObjective(_quad, SPACE), 8, batch_size=4, mesh=mesh_1x1)
    assert _states(study)[TrialState.COMPLETE] == 8
    assert study.system_attrs.get("ckpt:sharded:0") or study.system_attrs.get("ckpt:sharded:1")


def test_fakepod_bus_threads_pace_collectives_in_lockstep():
    """``FakePodBus`` is the thread form of a collective: a worker that
    skips an exchange leaves its peer waiting, and the barrier's timeout
    (shortened here) fails the round instead of hanging it."""
    bus = FakePodBus(2)
    bus._barrier = threading.Barrier(2, timeout=0.2)
    with pytest.raises(threading.BrokenBarrierError):
        bus.lockstep(lambda: bus.workers[0].exchange(), lambda: None)


# --------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_phase36a_sharded_mlp_on_the_card_equals_its_twin(cuda_device):
    """Phase 36(a) of ``chip_smoke.py`` at a small size: config #5's sharded
    MLP on a 1 x 1 mesh of the card and its ``optimize_vectorized`` twin,
    identical trial for trial."""
    import chip_smoke

    mesh = build_study_mesh({"trials": 1, "model": 1})
    runs = chip_smoke.sharded_twins(mesh, warmup=16, timed=32, batch=16)
    assert len(runs["sharded"]["study"].trials) == 48
    placed, _ = runs["objective"].sharded_model(mesh)
    assert placed["w1"].device.type == "cuda"
