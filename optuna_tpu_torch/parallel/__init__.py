"""Device-resident study loops (port of ``optuna_tpu/parallel``).

* :mod:`vectorized` — the :class:`VectorizedObjective` contract: a batched
  objective over an explicit search space;
* :mod:`scan_loop` — the device-resident study loop: trial history in
  power-of-two device buckets, the ask -> evaluate -> tell cycle as one
  chunk program per ``sync_every`` trials with O(n^2) incremental Cholesky
  tells (O(m^2) above the exact-size threshold), storage synced once per
  chunk.

:mod:`executor` holds only the deadline watchdog (``run_with_deadline``)
so far; the batch executor, ``optimize_vectorized``, the ICI journal and
the sharded pod loop are not ported yet (ROADMAP A7).
"""

from optuna_tpu_torch.parallel.scan_loop import optimize_scan
from optuna_tpu_torch.parallel.vectorized import VectorizedObjective

__all__ = ["VectorizedObjective", "optimize_scan"]
