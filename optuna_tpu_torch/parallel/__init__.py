"""Batched and device-resident study loops (port of ``optuna_tpu/parallel``).

* :mod:`vectorized` — batch ask -> one dispatch of a batched objective ->
  batch tell: B trials advance a dispatch (BASELINE config #5), through
  :func:`optimize_vectorized`;
* :mod:`executor` — the fault-tolerant dispatch loop behind it: non-finite
  quarantine, crash bisection, OOM batch halving, batch heartbeat
  failover, dispatch deadlines; a device fault is re-raised, not bisected;
* :mod:`scan_loop` — the device-resident study loop: trial history in
  power-of-two device buckets, the ask -> evaluate -> tell cycle as one
  chunk program per ``sync_every`` trials with O(n^2) incremental Cholesky
  tells (O(m^2) above the exact-size threshold), storage synced once per
  chunk, the carry checkpointed after each sync for ``resume=True``;
* :mod:`ici_journal` — a journal backend whose sync primitive is an
  all-gather over the process group instead of a file, so trial sync
  between ranks needs no server and no shared filesystem;
* :mod:`sharded` — execution on a 2-D ``{'trials', 'model'}``
  ``DeviceMesh``: the trial batch data-parallel over ``trials``, the user
  model tensor-parallel over ``model`` as ``DTensor`` placements from regex
  partition rules, per-shard containment, and lockstep trial sync over the
  ICI journal.
"""

from optuna_tpu_torch.parallel.executor import (
    NON_FINITE_POLICIES,
    DispatchTimeoutError,
    NonFiniteObjectiveError,
    ResilientBatchExecutor,
)
from optuna_tpu_torch.parallel.ici_journal import IciJournalBackend
from optuna_tpu_torch.parallel.scan_loop import optimize_scan
from optuna_tpu_torch.parallel.sharded import (
    PodFollowerStorage,
    ShardedBatchExecutor,
    ShardedObjective,
    build_study_mesh,
    make_shard_and_gather_fns,
    match_partition_rules,
    mesh_worker_id,
    optimize_sharded,
)
from optuna_tpu_torch.parallel.vectorized import VectorizedObjective, optimize_vectorized

__all__ = [
    "DispatchTimeoutError",
    "IciJournalBackend",
    "NON_FINITE_POLICIES",
    "NonFiniteObjectiveError",
    "PodFollowerStorage",
    "ResilientBatchExecutor",
    "ShardedBatchExecutor",
    "ShardedObjective",
    "VectorizedObjective",
    "build_study_mesh",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "mesh_worker_id",
    "optimize_scan",
    "optimize_sharded",
    "optimize_vectorized",
]
