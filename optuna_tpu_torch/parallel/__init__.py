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
  chunk, the carry checkpointed after each sync for ``resume=True``.

The pod tier (``parallel/sharded.py``, ``parallel/ici_journal.py``,
``PodFollowerStorage``, ``optimize_sharded``) waits for ROADMAP A8a.
"""

from optuna_tpu_torch.parallel.executor import (
    NON_FINITE_POLICIES,
    DispatchTimeoutError,
    NonFiniteObjectiveError,
    ResilientBatchExecutor,
)
from optuna_tpu_torch.parallel.scan_loop import optimize_scan
from optuna_tpu_torch.parallel.vectorized import VectorizedObjective, optimize_vectorized

__all__ = [
    "DispatchTimeoutError",
    "NON_FINITE_POLICIES",
    "NonFiniteObjectiveError",
    "ResilientBatchExecutor",
    "VectorizedObjective",
    "optimize_scan",
    "optimize_vectorized",
]
