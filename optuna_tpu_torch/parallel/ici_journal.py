"""Journal backend synchronized by a collective instead of a filesystem
(port of ``optuna_tpu/parallel/ici_journal.py``).

Every rank accumulates journal ops locally, and exchange points all-gather
the byte-packed op buffers across the ranks (``all_gather_into_tensor`` of
one ``uint8`` buffer a rank, over a gloo group: the payload is host bytes).
Replay order is deterministic: (round, rank, local sequence), so every rank
derives the identical global log with no server and no file.

Constraint (by construction of collectives): every rank must reach the
exchange points in lockstep, which is the execution model of the batch
loops. With one rank (or no process group) the exchange is a no-op gather,
so the same study code runs from one card to many.

:mod:`optuna_tpu_torch.parallel.sharded` makes the lockstep contract
executable: rank 0 leads the appends (each ``append_logs`` is one
collective), every other rank's writes are mirrored as paced empty
``exchange()`` calls by ``PodFollowerStorage``, and one barrier exchange
closes each sharded batch (the ``shard.exchange`` telemetry phase).

The packed buffer is the reference's byte for byte: a ``uint32`` length
header, then the ops as JSON lines with ``separators=(",", ":")``, zero
padded to ``buffer_bytes``; an overflow is refused before the collective.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages.journal._base import BaseJournalBackend

_logger = get_logger(__name__)

_HEADER = np.dtype(np.uint32).itemsize


class IciJournalBackend(BaseJournalBackend):
    def __init__(self, buffer_bytes: int = 1 << 20) -> None:
        self._buffer_bytes = buffer_bytes
        self._merged: list[dict[str, Any]] = []
        self._pending: list[dict[str, Any]] = []
        self._round = 0

    # ------------------------------------------------------------ exchange

    def _pack(self, logs: list[dict[str, Any]]) -> np.ndarray:
        payload = b"".join(json.dumps(log, separators=(",", ":")).encode() + b"\n" for log in logs)
        if len(payload) + _HEADER > self._buffer_bytes:
            raise ValueError(
                f"Journal exchange buffer overflow ({len(payload)} bytes); "
                "raise buffer_bytes or exchange more often."
            )
        buf = np.zeros(self._buffer_bytes, dtype=np.uint8)
        buf[:_HEADER] = np.frombuffer(np.uint32(len(payload)).tobytes(), dtype=np.uint8)
        buf[_HEADER : _HEADER + len(payload)] = np.frombuffer(payload, dtype=np.uint8)
        return buf

    @staticmethod
    def _unpack(buf: np.ndarray) -> list[dict[str, Any]]:
        n = int(np.frombuffer(buf[:_HEADER].tobytes(), dtype=np.uint32)[0])
        if n == 0:
            return []
        payload = buf[_HEADER : _HEADER + n].tobytes()
        return [json.loads(line) for line in payload.splitlines() if line]

    def _allgather(self, buf: np.ndarray) -> np.ndarray | None:
        """Group-wide gather of one packed buffer -> (P, buffer) rows in
        rank order; None means one rank (degenerate gather).

        Overridable seam: tests drive a fake multi-rank bus through it, and
        another transport can slot in without touching the merge and replay
        logic."""
        import torch
        import torch.distributed as dist

        from optuna_tpu_torch.parallel import _mesh

        world = _mesh.world_size()
        if world == 1:
            return None
        out = torch.empty(world * buf.size, dtype=torch.uint8)
        # all_gather_into_tensor, under the name newer releases give it.
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, torch.from_numpy(buf), group=_mesh.host_group())
        return out.numpy().reshape(world, buf.size)

    def exchange(self) -> None:
        """Collective sync point: all-gather every rank's pending ops and
        merge them in (round, rank, local order).

        Crash safety: ``_pending`` is only drained *after* the collective
        returns, so a failed or interrupted exchange loses nothing: the
        caller can retry and the ops ride the next round exactly once."""
        gathered = self._allgather(self._pack(self._pending))
        if gathered is None:
            # Degenerate gather: local ops become globally visible directly.
            self._merged.extend(self._pending)
            self._pending = []
            self._round += 1
            return
        self._pending = []
        for p in range(gathered.shape[0]):
            self._merged.extend(self._unpack(gathered[p]))
        self._round += 1

    # ------------------------------------------------------------- backend

    def append_logs(self, logs: list[dict[str, Any]]) -> None:
        self._pending.extend(logs)
        self.exchange()

    def read_logs(self, log_number_from: int) -> list[dict[str, Any]]:
        # Reads never run collectives (they are not lockstep-safe); they see
        # everything merged up to the last exchange. append_logs drains the
        # pending buffer synchronously, so there is nothing unmerged here.
        return self._merged[log_number_from:]
