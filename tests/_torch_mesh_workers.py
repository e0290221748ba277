"""Multi-rank scenarios of the port's sharded tier, run in spawned ranks.

Each rank is a process started by :func:`spawn_ranks` with
``torch.multiprocessing`` over a gloo group (``init_method="file://..."``,
no TCP port, a finite timeout), one intra-op thread a rank. A rank runs
every scenario of its suite in order and pickles what each returned (or
its traceback) for the test module to assert on. This module imports
torch and the port only: the ranks never load JAX.
"""

from __future__ import annotations

import datetime
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

#: Every collective of a scenario must finish within this, so a lost rank
#: fails the scenario instead of hanging the test.
PG_TIMEOUT_S = 90
SPAWN_TIMEOUT_S = 420


def spawn_ranks(suite: str, world: int, tmp: Path) -> list[dict[str, tuple[str, Any]]]:
    """Run ``suite`` on ``world`` spawned ranks; each rank's
    ``{scenario: ("ok", result) | ("error", traceback)}``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(world, suite, str(tmp)), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {suite} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    return [pickle.loads((tmp / f"{suite}-rank{r}.pkl").read_bytes()) for r in range(world)]


def _rank_main(rank: int, world: int, suite: str, tmp: str) -> None:
    import torch.distributed as dist

    import optuna_tpu_torch as ot

    torch.set_num_threads(1)
    ot.logging.set_verbosity(ot.logging.ERROR)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{tmp}/{suite}-pg",
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S),
    )
    results: dict[str, tuple[str, Any]] = {}
    for name, scenario in SUITES[suite]:
        try:
            results[name] = ("ok", scenario(rank, Path(tmp)))
        except BaseException:  # recorded for the test to report; the next scenario still runs
            results[name] = ("error", traceback.format_exc())
        try:
            dist.barrier()
        except Exception:  # a scenario that broke step leaves the barrier to time out; recorded above
            pass
    (Path(tmp) / f"{suite}-rank{rank}.pkl").write_bytes(pickle.dumps(results))
    dist.destroy_process_group()


# ---------------------------------------------------------------- objectives


def _space():
    from optuna_tpu_torch.distributions import FloatDistribution

    return {"x": FloatDistribution(0.0, 1.0)}


def quad(params):
    return (params["x"] - 0.3) ** 2


def mlp_model_and_x() -> tuple[dict, np.ndarray]:
    """``tests/test_sharded.py::_mlp_model_and_fn``'s model and inputs, from
    the same ``RandomState(0)`` draws."""
    rng = np.random.RandomState(0)
    model = {
        "w1": rng.normal(0, 0.1, (8, 16)).astype(np.float32),
        "b1": np.zeros(16, np.float32),
        "w2": rng.normal(0, 0.1, (16, 4)).astype(np.float32),
        "temperature": np.float32(1.0),
    }
    return model, rng.normal(size=(32, 8)).astype(np.float32)


MLP_RULES = [("w1", (None, "model")), ("b1", ("model",)), ("w2", ("model", None))]


def mlp_space():
    from optuna_tpu_torch.distributions import FloatDistribution

    return {"lr": FloatDistribution(0.01, 1.0, log=True), "scale": FloatDistribution(0.5, 2.0)}


def mlp_params_batch(b: int = 8) -> dict[str, np.ndarray]:
    rng = np.random.RandomState(5)
    return {
        "lr": np.exp(rng.uniform(np.log(0.01), 0.0, b)).astype(np.float32),
        "scale": rng.uniform(0.5, 2.0, b).astype(np.float32),
    }


def mlp_objective():
    """The reference's sharded MLP on ``DTensor`` s: per trial,
    ``mean((relu(x @ (w1 * scale) + b1) @ w2 / temperature)**2) * lr``."""
    from torch.distributed.tensor import DTensor, Replicate

    from optuna_tpu_torch.parallel import ShardedObjective

    model, x_np = mlp_model_and_x()
    x = torch.from_numpy(x_np)

    def fn(params, m):
        mesh = m["w1"].device_mesh
        dx = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        w1 = m["w1"].unsqueeze(0) * params["scale"].reshape(-1, 1, 1)
        h = torch.relu(torch.matmul(dx, w1) + m["b1"])
        out = torch.matmul(h, m["w2"]) / m["temperature"]
        return (out**2).mean(dim=(1, 2)) * params["lr"]

    return ShardedObjective(fn, mlp_space(), model=model, partition_rules=MLP_RULES)


# ---------------------------------------------------------------- helpers


def _fresh_telemetry():
    from optuna_tpu_torch import telemetry

    registry = telemetry.MetricsRegistry()
    telemetry.enable(registry)
    return registry


def _dispatches(registry) -> int:
    hist = registry.snapshot()["histograms"].get("phase.dispatch")
    return 0 if hist is None else int(hist["count"])


def _rows(study) -> list[tuple]:
    return [(t.number, dict(t.params), t.state.name, t.values) for t in study.get_trials(deepcopy=False)]


def _states(study) -> dict[str, int]:
    out: dict[str, int] = {}
    for t in study.get_trials(deepcopy=False):
        out[t.state.name] = out.get(t.state.name, 0) + 1
    return out


def _mesh(shape: dict):
    from optuna_tpu_torch.parallel import build_study_mesh

    return build_study_mesh(shape, device="cpu")


def _run(rank: int, study, objective, n_trials: int, mesh, **kwargs) -> None:
    """Every rank calls alike; only rank 0 holds the study (mode 1)."""
    from optuna_tpu_torch.parallel import optimize_sharded

    optimize_sharded(study if rank == 0 else None, objective, n_trials, mesh=mesh, **kwargs)


def _follower_view(rank: int, registry, extra: dict | None = None) -> dict | None:
    if rank == 0:
        return None
    return {"dispatches": _dispatches(registry), **(extra or {})}


# ------------------------------------------------------------- 2 ranks


def degenerate_in_memory(rank: int, tmp: Path) -> Any:
    """Mode 1 at ``{'trials': 2, 'model': 1}`` over an in-memory study."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.samplers import RandomSampler

    registry = _fresh_telemetry()
    mesh = _mesh({"trials": 2, "model": 1})
    study = ot.create_study(sampler=RandomSampler(seed=11)) if rank == 0 else None
    _run(rank, study, VectorizedObjective(quad, _space()), 20, mesh, batch_size=8)
    if rank:
        return _follower_view(rank, registry)
    return {"rows": _rows(study), "best": study.best_value, "dispatches": _dispatches(registry)}


def degenerate_ici_journal(rank: int, tmp: Path) -> Any:
    """The pod at ``{'trials': 2, 'model': 1}``: every rank runs the loop
    over its own ``JournalStorage(IciJournalBackend())``."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import IciJournalBackend, VectorizedObjective, optimize_sharded
    from optuna_tpu_torch.samplers import RandomSampler
    from optuna_tpu_torch.storages.journal import JournalStorage

    registry = _fresh_telemetry()
    mesh = _mesh({"trials": 2, "model": 1})
    backend = IciJournalBackend()
    storage = JournalStorage(backend)
    if rank == 0:
        storage.create_new_study([ot.study.StudyDirection.MINIMIZE], study_name="pod")
    else:
        backend.exchange()  # pace the leader's create
    study = ot.load_study(study_name="pod", storage=storage, sampler=RandomSampler(seed=11))
    optimize_sharded(study, VectorizedObjective(quad, _space()), 20, batch_size=8, mesh=mesh)
    exchanges = registry.snapshot()["histograms"].get("phase.shard.exchange", {}).get("count", 0)
    return {
        "rows": _rows(study),
        "best": study.best_value,
        "logs": backend.read_logs(0),
        "exchanges": exchanges,
        "suppressed_restored": "_health_reporter" not in study.__dict__,
    }


def poison_row_on_one_rank(rank: int, tmp: Path) -> Any:
    """An objective whose rows raise on the rank that holds the poison
    only: the gather's status makes it the same error on both ranks."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.samplers import RandomSampler

    def fn(params):
        if bool((params["x"] > 0.97).any()):
            raise RuntimeError("poison row")
        return quad(params)

    registry = _fresh_telemetry()
    mesh = _mesh({"trials": 2, "model": 1})
    study = None
    if rank == 0:
        study = ot.create_study(sampler=RandomSampler(seed=2))
        study.enqueue_trial({"x": 0.99})
    t0 = time.monotonic()
    _run(rank, study, VectorizedObjective(fn, _space()), 8, mesh, batch_size=4)
    seconds = time.monotonic() - t0
    if rank:
        return _follower_view(rank, registry, {"seconds": seconds})
    return {"rows": _rows(study), "dispatches": _dispatches(registry), "seconds": seconds}


def deadline_on_one_rank(rank: int, tmp: Path) -> Any:
    """Rows that hang on one rank only, under ``dispatch_deadline_s``: the
    timed-out status is gathered, so both ranks reach one verdict."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.samplers import RandomSampler

    def fn(params):
        if bool((params["x"] > 0.97).any()):
            time.sleep(1.5)
        return quad(params)

    registry = _fresh_telemetry()
    mesh = _mesh({"trials": 2, "model": 1})
    study = None
    if rank == 0:
        study = ot.create_study(sampler=RandomSampler(seed=2))
        study.enqueue_trial({"x": 0.99})
    error = None
    try:
        _run(rank, study, VectorizedObjective(fn, _space()), 8, mesh, batch_size=4, dispatch_deadline_s=0.5)
    except Exception as err:  # the verdict under test: recorded on every rank
        error = type(err).__name__
    out = {"error": error, "dispatches": _dispatches(registry)}
    if rank == 0:
        out["rows"] = _rows(study)
        out["timeouts"] = registry.snapshot()["counters"].get("executor.dispatch_timeout", 0)
    return out


def oom_on_one_rank(rank: int, tmp: Path) -> Any:
    """Rank 1 runs out of memory whenever it holds more than one row: the
    gathered status makes it an OOM on both ranks, which halve until each
    holds one row (the floor: one row a trials shard)."""
    import optuna_tpu_torch as ot
    import torch.distributed as dist
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.samplers import RandomSampler

    def fn(params):
        if dist.get_rank() == 1 and params["x"].shape[0] > 1:
            raise torch.OutOfMemoryError("out of memory (injected on rank 1)")
        return quad(params)

    registry = _fresh_telemetry()
    study = ot.create_study(sampler=RandomSampler(seed=3)) if rank == 0 else None
    _run(rank, study, VectorizedObjective(fn, _space()), 8, _mesh({"trials": 2, "model": 1}), batch_size=8)
    out = {"dispatches": _dispatches(registry)}
    if rank == 0:
        out["states"] = _states(study)
        out["halvings"] = registry.snapshot()["counters"].get("executor.oom_halving", 0)
    return out


def device_fault_on_one_rank(rank: int, tmp: Path) -> Any:
    """A CUDA-error-shaped fault on rank 1 only is a device fault on both:
    rank 0 FAILs the batch and re-raises, and rank 1 raises with it."""
    import optuna_tpu_torch as ot
    import torch.distributed as dist
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.samplers import RandomSampler

    def fn(params):
        if dist.get_rank() == 1:
            raise RuntimeError("CUDA error: an illegal memory access was encountered (injected on rank 1)")
        return quad(params)

    study = ot.create_study(sampler=RandomSampler(seed=3)) if rank == 0 else None
    error = None
    try:
        _run(rank, study, VectorizedObjective(fn, _space()), 8, _mesh({"trials": 2, "model": 1}), batch_size=4)
    except Exception as err:  # the verdict under test: recorded on every rank
        error = f"{type(err).__name__}: {err}"
    out = {"error": error}
    if rank == 0:
        out["states"] = _states(study)
    return out


def upload_fault_on_one_rank(rank: int, tmp: Path) -> Any:
    """Rank 1's upload of its rows fails once: the upload runs inside the
    dispatch's status boundary, so it is one agreed error on both ranks,
    contained alike, and the ranks stay in step."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.parallel.executor import ResilientBatchExecutor
    from optuna_tpu_torch.samplers import RandomSampler

    upload = ResilientBatchExecutor._upload
    failures = [RuntimeError("pinned copy failed (injected on rank 1)")] if rank == 1 else []

    def flaky_upload(self, args):
        if failures:
            raise failures.pop()
        return upload(self, args)

    registry = _fresh_telemetry()
    study = ot.create_study(sampler=RandomSampler(seed=4)) if rank == 0 else None
    ResilientBatchExecutor._upload = flaky_upload
    try:
        _run(rank, study, VectorizedObjective(quad, _space()), 8, _mesh({"trials": 2, "model": 1}), batch_size=4)
    finally:
        ResilientBatchExecutor._upload = upload
    out = {"dispatches": _dispatches(registry)}
    if rank == 0:
        out["states"] = _states(study)
        out["bisections"] = registry.snapshot()["counters"].get("executor.bisection", 0)
    return out


SUITE_TWO = [
    ("degenerate_in_memory", degenerate_in_memory),
    ("degenerate_ici_journal", degenerate_ici_journal),
    ("poison_row_on_one_rank", poison_row_on_one_rank),
    ("deadline_on_one_rank", deadline_on_one_rank),
    ("oom_on_one_rank", oom_on_one_rank),
    ("device_fault_on_one_rank", device_fault_on_one_rank),
    ("upload_fault_on_one_rank", upload_fault_on_one_rank),
]


# ------------------------------------------------------------- 2 x 2 ranks

MESH_2X2 = {"trials": 2, "model": 2}


def rules_round_trip(rank: int, tmp: Path) -> Any:
    from optuna_tpu_torch.parallel import make_shard_and_gather_fns, match_partition_rules
    from optuna_tpu_torch.parallel.sharded import _apply

    mesh = _mesh(MESH_2X2)
    tree = {"w": np.arange(32, dtype=np.float32).reshape(4, 8), "s": np.float32(3.0)}
    specs = match_partition_rules([("w", (None, "model"))], tree)
    shard_fns, gather_fns = make_shard_and_gather_fns(mesh, specs)
    placed = _apply(shard_fns, tree)
    back = _apply(gather_fns, placed)
    return {
        "w": back["w"],
        "s": float(back["s"]),
        "local_w": tuple(placed["w"].to_local().shape),
        "placements": [str(p) for p in placed["w"].placements],
        "coordinate": list(mesh.get_coordinate()),
    }


def sharded_mlp(rank: int, tmp: Path) -> Any:
    """The MLP objective's values for one params batch, its local shards,
    and a sharded study over it."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import TPESampler

    mesh = _mesh(MESH_2X2)
    obj = mlp_objective()
    placed, _ = obj.sharded_model(mesh)
    batch = mlp_params_batch()
    values, finite = obj.guarded(mesh, "trials")({k: torch.from_numpy(v) for k, v in batch.items()})
    study = ot.create_study(sampler=TPESampler(seed=3, device="cpu")) if rank == 0 else None
    _run(rank, study, obj, 16, mesh, batch_size=8)
    gathered = obj.gathered_model(mesh)
    out = {
        "local": {k: tuple(v.to_local().shape) for k, v in placed.items()},
        "placements": {k: [str(p) for p in v.placements] for k, v in placed.items()},
        "values": values.numpy(),
        "finite": finite.numpy(),
        "w1_round_trip": bool(np.array_equal(gathered["w1"], mlp_model_and_x()[0]["w1"])),
    }
    if rank == 0:
        out["states"] = _states(study)
        out["all_finite"] = all(np.isfinite(t.value) for t in study.trials)
    return out


def _faulty(**kwargs):
    from optuna_tpu_torch.testing.fault_injection import FaultyVectorizedObjective

    return FaultyVectorizedObjective(quad, _space(), **kwargs)


def _snap(registry) -> dict:
    snap = registry.snapshot()
    return {"counters": dict(snap["counters"]), "gauges": dict(snap["gauges"])}


def transient_crash(rank: int, tmp: Path) -> Any:
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import RandomSampler

    registry = _fresh_telemetry()
    obj = _faulty(raise_at=(0,))
    study = ot.create_study(sampler=RandomSampler(seed=1)) if rank == 0 else None
    _run(rank, study, obj, 4, _mesh(MESH_2X2), batch_size=4)
    out = {"widths": obj.dispatch_widths, **_snap(registry)}
    if rank == 0:
        out["states"] = _states(study)
    return out


def poison_trial(rank: int, tmp: Path) -> Any:
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import RandomSampler

    def raise_when(host):
        return bool((host["x"] > 0.97).any())

    _fresh_telemetry()
    study = None
    if rank == 0:
        study = ot.create_study(sampler=RandomSampler(seed=2))
        study.enqueue_trial({"x": 0.99})
    _run(rank, study, _faulty(raise_when=raise_when), 8, _mesh(MESH_2X2), batch_size=4)
    return None if rank else {"rows": _rows(study)}


def _chaos_plan():
    from optuna_tpu_torch.testing.fault_injection import ShardChaosPlan

    return ShardChaosPlan(mesh_trials=2, mesh_model=2, batch_size=4, n_trials=12)


def nan_slots(rank: int, tmp: Path) -> Any:
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import RandomSampler

    out = {}
    for policy in ("fail", "clip"):
        plan = _chaos_plan()
        registry = _fresh_telemetry()
        study = ot.create_study(sampler=RandomSampler(seed=4)) if rank == 0 else None
        obj = _faulty(nan_at=dict(plan.nan_slots))
        _run(rank, study, obj, plan.batch_size, _mesh(MESH_2X2), batch_size=plan.batch_size, non_finite=policy)
        if rank == 0:
            out[policy] = {"states": _states(study), **_snap(registry)}
    return out or None


def fully_quarantined_shard(rank: int, tmp: Path) -> Any:
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import RandomSampler

    registry = _fresh_telemetry()
    study = ot.create_study(sampler=RandomSampler(seed=4)) if rank == 0 else None
    _run(rank, study, _faulty(nan_at={d: (0, 1) for d in range(3)}), 12, _mesh(MESH_2X2), batch_size=4)
    return _snap(registry) if rank == 0 else None


def fault_free_twin(rank: int, tmp: Path) -> Any:
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.samplers import RandomSampler

    registry = _fresh_telemetry()
    study = ot.create_study(sampler=RandomSampler(seed=4)) if rank == 0 else None
    _run(rank, study, VectorizedObjective(quad, _space()), 4, _mesh(MESH_2X2), batch_size=4)
    return _snap(registry) if rank == 0 else None


def _heartbeat_storage(path: Path, name: str):
    from optuna_tpu_torch.storages import RetryFailedTrialCallback
    from optuna_tpu_torch.storages._rdb.storage import RDBStorage

    return RDBStorage(
        f"sqlite:///{path / name}",
        heartbeat_interval=60,
        grace_period=120,
        failed_trial_callback=RetryFailedTrialCallback(max_retry=2),
    )


def _age_heartbeats(storage) -> None:
    con = storage._conn()
    con.execute("UPDATE trial_heartbeats SET heartbeat = heartbeat - 100000")
    con.commit()


def kill_reap_drain(rank: int, tmp: Path) -> Any:
    """Mode 1 over sqlite with heartbeats: every rank dies at dispatch 1;
    rank 0 reaps the stranded batch and every rank drains the clones."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.samplers import RandomSampler
    from optuna_tpu_torch.storages._callbacks import EXECUTOR_ATTR_PREFIX
    from optuna_tpu_torch.storages._heartbeat import fail_stale_trials
    from optuna_tpu_torch.testing.fault_injection import SimulatedWorkerDeath

    _fresh_telemetry()
    mesh = _mesh(MESH_2X2)
    clean = ot.create_study(sampler=RandomSampler(seed=9)) if rank == 0 else None
    _run(rank, clean, VectorizedObjective(quad, _space()), 8, mesh, batch_size=4)
    storage = study = None
    if rank == 0:
        storage = _heartbeat_storage(tmp, "kill.db")
        study = ot.create_study(study_name="kill", storage=storage, sampler=RandomSampler(seed=9))
    died = False
    try:
        _run(rank, study, _faulty(kill_at={1}), 8, mesh, batch_size=4)
    except SimulatedWorkerDeath:
        died = True
    out: dict = {"died": died}
    survivor = None
    n_clones = 0
    if rank == 0:
        out["running_after_death"] = _states(study).get("RUNNING", 0)
        _age_heartbeats(storage)
        survivor = ot.load_study(study_name="kill", storage=storage, sampler=RandomSampler(seed=99))
        fail_stale_trials(survivor)
        clones = [t for t in survivor.trials if t.state == ot.TrialState.WAITING]
        n_clones = len(clones)
        out["clones"] = n_clones
        out["clones_clean"] = not any(k.startswith(EXECUTOR_ATTR_PREFIX) for c in clones for k in c.system_attrs)
        out["clones_lineage"] = all("fixed_params" in c.system_attrs and "failed_trial" in c.system_attrs for c in clones)
    # Every rank needs the drain's width: the same count as rank 0's clones.
    n_clones = _broadcast_int(n_clones)
    _run(rank, survivor, VectorizedObjective(quad, _space()), n_clones, mesh, batch_size=4)
    if rank == 0:
        out["final"] = _states(survivor)
        out["values"] = sorted(t.value for t in survivor.trials if t.state == ot.TrialState.COMPLETE)
        out["clean_values"] = sorted(t.value for t in clean.trials)
        out["best"], out["clean_best"] = survivor.best_value, clean.best_value
    return out


def _broadcast_int(value: int) -> int:
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return int(box[0])


def chaos_acceptance(rank: int, tmp: Path) -> Any:
    """NaN rows on shard t0 and a killed worker in one study, at 2 x 2."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import VectorizedObjective
    from optuna_tpu_torch.samplers import RandomSampler
    from optuna_tpu_torch.storages import RetryFailedTrialCallback
    from optuna_tpu_torch.storages._heartbeat import fail_stale_trials
    from optuna_tpu_torch.testing.fault_injection import SimulatedWorkerDeath, plant_dead_worker

    plan = _chaos_plan()
    mesh = _mesh({"trials": plan.mesh_trials, "model": plan.mesh_model})
    registry = _fresh_telemetry()
    clean = ot.create_study(sampler=RandomSampler(seed=21)) if rank == 0 else None
    _run(rank, clean, VectorizedObjective(quad, _space()), plan.n_trials, mesh, batch_size=plan.batch_size)
    out: dict = {}
    storage = study = None
    if rank == 0:
        out["clean_states"] = _states(clean)
        out["clean_counters"] = dict(registry.snapshot()["counters"])
        out["clean_params"] = sorted(t.params["x"] for t in clean.trials)
        out["clean_best"] = clean.best_value
        storage = _heartbeat_storage(tmp, "chaos.db")
        study = ot.create_study(study_name="podchaos", storage=storage, sampler=RandomSampler(seed=21))
    _fresh_telemetry()
    obj = _faulty(nan_at=dict(plan.nan_slots), kill_at={plan.kill_dispatch})
    died = False
    try:
        _run(rank, study, obj, plan.n_trials, mesh, batch_size=plan.batch_size)
    except SimulatedWorkerDeath:
        died = True
    out["died"] = died
    survivor = None
    remaining = 0
    if rank == 0:
        plant_dead_worker(study, worker_id=plan.dead_worker_id, age_s=plan.dead_worker_age_s)
        _age_heartbeats(storage)
        survivor = ot.load_study(study_name="podchaos", storage=storage, sampler=RandomSampler(seed=77))
        fail_stale_trials(survivor)
        out["running_after_reap"] = _states(survivor).get("RUNNING", 0)
        report = survivor.health_report()
        out["findings"] = {f["check"]: {"summary": f["summary"], "evidence": f["evidence"]} for f in report["findings"]}
        retry = RetryFailedTrialCallback()
        for t in survivor.trials:
            if t.state == ot.TrialState.FAIL and "non-finite" in t.system_attrs.get("fail_reason", ""):
                retry(survivor, t)
        out["waiting"] = sum(t.state == ot.TrialState.WAITING for t in survivor.trials)
        remaining = plan.n_trials - _states(survivor).get("COMPLETE", 0)
    remaining = _broadcast_int(remaining)
    _run(rank, survivor, VectorizedObjective(quad, _space()), remaining, mesh, batch_size=plan.batch_size)
    if rank == 0:
        out["final"] = _states(survivor)
        out["final_params"] = sorted(t.params["x"] for t in survivor.trials if t.state == ot.TrialState.COMPLETE)
        out["best"] = survivor.best_value
    return out


SUITE_FOUR = [
    ("rules_round_trip", rules_round_trip),
    ("sharded_mlp", sharded_mlp),
    ("transient_crash", transient_crash),
    ("poison_trial", poison_trial),
    ("nan_slots", nan_slots),
    ("fully_quarantined_shard", fully_quarantined_shard),
    ("fault_free_twin", fault_free_twin),
    ("kill_reap_drain", kill_reap_drain),
    ("chaos_acceptance", chaos_acceptance),
]


# ------------------------------------------------------------- the journal


def journal_exchange(rank: int, tmp: Path) -> Any:
    """Two ranks push distinct ops through the real all-gather."""
    from optuna_tpu_torch.parallel import IciJournalBackend

    backend = IciJournalBackend()
    backend.append_logs([{"op": "from", "proc": rank, "seq": 0}])
    backend.append_logs([{"op": "from", "proc": rank, "seq": 1}])
    return {"merged": backend.read_logs(0), "round": backend._round}


SUITE_JOURNAL = [("journal_exchange", journal_exchange)]

SUITES: dict[str, list[tuple[str, Callable]]] = {
    "two": SUITE_TWO,
    "four": SUITE_FOUR,
    "journal": SUITE_JOURNAL,
}


def result(per_rank: list[dict], scenario: str, rank: int = 0) -> Any:
    """One rank's result of one scenario; its traceback as the failure."""
    status, value = per_rank[rank][scenario]
    if status != "ok":
        raise AssertionError(f"rank {rank} of {scenario} failed:\n{value}")
    return value

