"""Op tokens for exactly-once resume (port of the op-token half of
``optuna_tpu/checkpoint.py``).

Loops stamp every synced trial with a deterministic op token (the
``ckpt:op`` trial system attr, written before the trial is told). A resume
classifies the history with :func:`synced_ops`: already-told ops are never
re-told, token-stamped RUNNING strays are adopted, tokenless RUNNING strays
are reaped. The scan loop writes the same tokens as the reference, so a
history the port writes now carries what a resume needs.

The CRC-framed checkpoint blobs (``encode/write/load_checkpoint``, the
``ckpt:<kind>:<slot>`` ring, ``max_slot_seq``) and the sampler-state hooks
are ROADMAP A8.
"""

from __future__ import annotations

import dataclasses
from typing import Any

#: Trial-system-attr key carrying a synced trial's deterministic op token.
OP_TOKEN_ATTR = "ckpt:op"

#: Trial-system-attr marker on a RUNNING stray reaped at resume: the trial
#: was created by a dead process and never told, so it is failed out of the
#: way and excluded from the study's tell budget.
STRANDED_ATTR = "ckpt:stranded"


def op_token(run_id: int, chunk: int | str, slot: int) -> str:
    """The deterministic op token for one synced trial.

    ``run_id`` namespaces loop incarnations; ``chunk`` is the scan chunk
    index (or ``"s"`` for the Sobol startup block); ``slot`` is the
    in-chunk position.
    """
    return f"r{int(run_id)}:c{chunk}:{int(slot)}"


def parse_op_token(token: Any) -> tuple[int, int | None, int] | None:
    """``(run_id, chunk, slot)`` for a well-formed op token, else None.

    ``chunk`` is None for startup-block tokens (``c`` part spells ``"s"``).
    Malformed tokens parse to None and count as tokenless.
    """
    try:
        run_part, chunk_part, slot_part = str(token).split(":")
        run_id = int(run_part[1:]) if run_part.startswith("r") else None
        if run_id is None or not chunk_part.startswith("c"):
            return None
        chunk = None if chunk_part[1:] == "s" else int(chunk_part[1:])
        return run_id, chunk, int(slot_part)
    except (ValueError, IndexError):
        return None


@dataclasses.dataclass(frozen=True)
class SyncedOps:
    """What resume learns from the trial history's op tokens."""

    #: Op tokens of finished (budget-consuming) trials.
    told: frozenset[str]
    #: Op token -> trial id for token-stamped RUNNING strays: adoptable.
    running: dict[str, int]
    #: Trial ids of tokenless RUNNING strays: reaped to FAIL at resume.
    stranded: tuple[int, ...]
    #: Highest run id any token carries (-1 when no tokens exist yet).
    max_run_id: int


def synced_ops(trials: Any) -> SyncedOps:
    """Classify a study's trials by op token.

    ``trials`` is a sequence of FrozenTrials. Trials already marked
    ``ckpt:stranded`` are excluded from ``told``: they never consumed
    budget.
    """
    told: set[str] = set()
    running: dict[str, int] = {}
    stranded: list[int] = []
    max_run_id = -1
    for trial in trials:
        attrs = trial.system_attrs
        token = attrs.get(OP_TOKEN_ATTR)
        parsed = parse_op_token(token) if token is not None else None
        if parsed is not None:
            max_run_id = max(max_run_id, parsed[0])
        if trial.state.is_finished():
            if parsed is not None and STRANDED_ATTR not in attrs:
                told.add(str(token))
        elif trial.state.name == "RUNNING":
            if parsed is not None:
                running[str(token)] = trial._trial_id
            else:
                stranded.append(trial._trial_id)
    return SyncedOps(
        told=frozenset(told),
        running=running,
        stranded=tuple(stranded),
        max_run_id=max_run_id,
    )
