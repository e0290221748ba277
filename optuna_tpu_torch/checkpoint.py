"""Preemption-safe durable checkpoints for device-resident optimization state
(port of ``optuna_tpu/checkpoint.py``).

A loop's device state (history buckets, the inducing set, kernel params,
draw counters) dies with its process. This module snapshots that state at
the boundaries the loops already visit (the scan chunk sync) and restores it
exactly once on resume:

* **Framing.** Each checkpoint is a pickled record wrapped in the journal's
  CRC frame (``storages/journal/_file.py::frame_snapshot``) and base64'd
  into a study system attr, so every storage backend that replicates study
  attrs replicates checkpoints. A torn or bit-rotted blob fails its CRC and
  reads as "no checkpoint", never as garbage fed to pickle. A blob holds
  only plain types and NumPy arrays, so either package decodes the other's.
* **Bounded ring.** Writes alternate between two slots per kind
  (``ckpt:<kind>:0`` / ``ckpt:<kind>:1``), so storage holds at most two
  blobs per loop and a write torn mid-flight still leaves the previous
  slot intact. Restore picks the newest *valid* slot by sequence number.
* **Trust-but-verify restore.** A blob is used only if its CRC verifies,
  its schema version matches, and its trial-count watermark is consistent
  with the storage's synced history. Every rejection is counted
  (``checkpoint.rejected`` / ``checkpoint.stale``); the caller falls back to
  its recompute-from-COMPLETE-history path, never aborts.
* **Exactly-once tells.** Loops stamp every synced trial with a
  deterministic op token (``ckpt:op`` system attr). On resume the re-run
  chunk consults :func:`synced_ops`: already-told ops are skipped,
  token-stamped RUNNING strays are adopted, and tokenless RUNNING strays
  are reaped, so no synced trial is ever re-told.

Events are counted as ``checkpoint.<event>`` with the vocabulary in
:data:`CHECKPOINT_EVENTS` (chaos matrix:
``testing/fault_injection.py::CHECKPOINT_CHAOS_MATRIX``).
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import pickle
from typing import Any, Mapping

from optuna_tpu_torch import telemetry
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.storages.journal._file import frame_snapshot, unframe_snapshot

_logger = get_logger(__name__)

#: Bump when the record layout or any kind's ``state`` payload changes
#: incompatibly. A version-mismatched blob is *rejected* (counted, logged,
#: fallen back from) — never interpreted.
CHECKPOINT_SCHEMA_VERSION = 1

#: Study-system-attr namespace everything checkpoint-shaped lives under.
CKPT_ATTR_PREFIX = "ckpt:"

#: Trial-system-attr key carrying a synced trial's deterministic op token.
OP_TOKEN_ATTR = "ckpt:op"

#: Trial-system-attr marker on a RUNNING stray reaped at resume: the trial
#: was created by a dead process and never told, so it is failed out of the
#: way and excluded from the study's tell budget.
STRANDED_ATTR = "ckpt:stranded"

#: Ring size per checkpoint kind: two slots means one torn write can never
#: destroy the last good blob, while storage stays O(1) per loop.
RING_SLOTS = 2

#: The checkpoint event vocabulary, counted as ``checkpoint.<event>``; every
#: event has a preemption scenario in
#: ``testing/fault_injection.py::CHECKPOINT_CHAOS_MATRIX``. ``warm_load`` is
#: the serve tier's: a re-homing fleet hub counts it
#: (``storages/_grpc/fleet.py::FleetHub._warm_load``).
CHECKPOINT_EVENTS: dict[str, str] = {
    "write": "a loop boundary persisted a CRC-framed state blob into the ckpt: ring",
    "write_error": "a best-effort checkpoint write failed; the loop continued without it",
    "restore": "a resume rebuilt loop state from the newest valid blob",
    "rejected": "a blob failed CRC / schema-version / decode validation and was skipped",
    "stale": "a blob's trial-count watermark trailed the synced history and was skipped",
    "fallback": "no valid blob survived validation; state was recomputed from COMPLETE history",
    "warm_load": "a re-homing hub successor restored the dead hub's fitted sampler state",
}


def _count(event: str, meta: dict | None = None) -> None:
    # ``meta`` rides to the flight recorder's timeline event only.
    telemetry.count("checkpoint." + event, meta=meta)


@dataclasses.dataclass(frozen=True)
class CheckpointRecord:
    """One decoded, validated checkpoint blob."""

    kind: str
    seq: int
    n_told: int
    state: dict[str, Any]
    #: Lease fencing epoch the writer held when it captured the state (0 =
    #: written outside any lease, as every loop kind is). Carried for
    #: provenance, and so that blobs stay byte-identical to the reference's.
    fence: int = 0


def _slot_key(kind: str, slot: int) -> str:
    return f"{CKPT_ATTR_PREFIX}{kind}:{slot}"


def encode_checkpoint(
    kind: str, state: Mapping[str, Any], *, n_told: int, seq: int, fence: int = 0
) -> str:
    """Pickle + CRC-frame + base64 a checkpoint record into an attr value.

    ``fence`` stamps the writer's lease fencing epoch into the frame (an
    additive dict key: version-1 blobs without it decode as fence 0, so no
    schema bump)."""
    payload = pickle.dumps(
        {
            "version": CHECKPOINT_SCHEMA_VERSION,
            "kind": kind,
            "seq": int(seq),
            "n_told": int(n_told),
            "fence": int(fence),
            "state": dict(state),
        },
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    return base64.b64encode(frame_snapshot(payload)).decode("ascii")


def write_checkpoint(
    storage: Any,
    study_id: int,
    kind: str,
    state: Mapping[str, Any],
    *,
    n_told: int,
    seq: int,
    fence: int = 0,
) -> bool:
    """Best-effort durable write of one checkpoint into the 2-slot ring.

    ``seq`` is the writer's monotonically increasing write count for this
    kind: it picks the ring slot (``seq % 2``) and breaks ties at restore
    (newest valid slot wins). ``n_told`` is the trial-count watermark: how
    many budget-consuming tells the writer had durably synced when the
    state was captured. Returns False (after counting
    ``checkpoint.write_error``) instead of raising — a checkpoint is a
    recovery accelerant, never worth failing the loop over.
    """
    key = _slot_key(kind, int(seq) % RING_SLOTS)
    try:
        with telemetry.span("ckpt.write"):
            blob = encode_checkpoint(kind, state, n_told=n_told, seq=seq, fence=fence)
            storage.set_study_system_attr(study_id, key, blob)
    except Exception as err:  # graphlint: ignore[PY001] -- best-effort by contract: any storage/pickle failure must degrade to "no checkpoint", not kill the optimization loop (a StaleLeaseError from a fenced hub storage lands here too: the fence already counted and demoted, and a zombie's checkpoint is exactly a write to skip)
        _count("write_error", meta={"kind": kind, "seq": int(seq)})
        _logger.warning(
            f"Best-effort checkpoint write ({kind!r} seq {seq}) failed and was "
            f"skipped; the loop continues uncheckpointed until the next boundary: {err!r}"
        )
        return False
    _count("write", meta={"kind": kind, "seq": int(seq), "n_told": int(n_told)})
    return True


def _decode_slot(blob: Any, *, kind: str, key: str) -> CheckpointRecord | None:
    """Decode + validate one ring slot; None (counted) on any defect."""
    if not isinstance(blob, str):
        _count("rejected", meta={"key": key, "defect": "not_a_string"})
        _logger.warning(f"Checkpoint attr {key} holds a non-string value; rejecting it.")
        return None
    try:
        framed = base64.b64decode(blob.encode("ascii"), validate=True)
    except (binascii.Error, ValueError, UnicodeEncodeError):
        _count("rejected", meta={"key": key, "defect": "base64"})
        _logger.warning(f"Checkpoint attr {key} is not valid base64; rejecting it.")
        return None
    payload = unframe_snapshot(framed, source=f"checkpoint attr {key}")
    if payload is None:
        _count("rejected", meta={"key": key, "defect": "crc"})
        return None
    try:
        record = pickle.loads(payload)
    except (pickle.UnpicklingError, AttributeError, ImportError, EOFError) as err:
        _count("rejected", meta={"key": key, "defect": "unpickle"})
        _logger.warning(
            f"Checkpoint attr {key} passed its CRC but failed to unpickle "
            f"(version drift?); rejecting it: {err!r}"
        )
        return None
    if not isinstance(record, dict) or record.get("version") != CHECKPOINT_SCHEMA_VERSION:
        _count("rejected", meta={"key": key, "defect": "schema_version"})
        _logger.warning(
            f"Checkpoint attr {key} carries schema version "
            f"{record.get('version') if isinstance(record, dict) else '?'} "
            f"(want {CHECKPOINT_SCHEMA_VERSION}); rejecting it."
        )
        return None
    if record.get("kind") != kind:
        _count("rejected", meta={"key": key, "defect": "kind_mismatch"})
        _logger.warning(
            f"Checkpoint attr {key} says kind {record.get('kind')!r} (want "
            f"{kind!r}); rejecting it."
        )
        return None
    state = record.get("state")
    if not isinstance(state, dict):
        _count("rejected", meta={"key": key, "defect": "state_shape"})
        return None
    return CheckpointRecord(
        kind=kind,
        seq=int(record.get("seq", 0)),
        n_told=int(record.get("n_told", 0)),
        state=state,
        fence=int(record.get("fence", 0)),
    )


def load_checkpoint(
    storage: Any,
    study_id: int,
    kind: str,
    *,
    synced_told: int | None = None,
    max_lag: int | None = None,
) -> CheckpointRecord | None:
    """The newest valid checkpoint of ``kind``, or None (counted) if none.

    Validation is trust-but-verify, per slot: base64 + CRC frame + schema
    version + kind. When the caller passes ``synced_told`` — its own count
    of durably synced tells — the watermark is checked too: a blob whose
    ``n_told`` exceeds ``synced_told`` comes from a timeline the storage
    has since lost (counted ``checkpoint.rejected``); a blob trailing
    ``synced_told`` by more than ``max_lag`` (the writer's per-interval
    tell bound) is **stale** — the history moved on past the point the
    blob can be reconciled to — counted ``checkpoint.stale`` and skipped.
    All rejections degrade to None; callers fall back to recompute, never
    abort.
    """
    try:
        attrs = storage.get_study_system_attrs(study_id)
    except Exception as err:  # graphlint: ignore[PY001] -- restore is best-effort by contract: a storage read fault must degrade to the recompute path, not abort the resume
        _logger.warning(f"Checkpoint attr read failed; resuming without one: {err!r}")
        return None
    best: CheckpointRecord | None = None
    for slot in range(RING_SLOTS):
        key = _slot_key(kind, slot)
        if key not in attrs:
            continue
        record = _decode_slot(attrs[key], kind=kind, key=key)
        if record is None:
            continue
        if best is None or record.seq > best.seq:
            best = record
    if best is None:
        return None
    if synced_told is not None:
        if best.n_told > synced_told:
            _count(
                "rejected",
                meta={"kind": kind, "defect": "future_watermark", "n_told": best.n_told},
            )
            _logger.warning(
                f"Checkpoint {kind!r} seq {best.seq} claims {best.n_told} synced "
                f"tells but storage holds {synced_told}; rejecting the blob "
                "(lost-history timeline) and recomputing from COMPLETE trials."
            )
            return None
        if max_lag is not None and synced_told - best.n_told > max_lag:
            _count(
                "stale",
                meta={
                    "kind": kind,
                    "n_told": best.n_told,
                    "synced_told": synced_told,
                    "max_lag": max_lag,
                },
            )
            _logger.warning(
                f"Checkpoint {kind!r} seq {best.seq} is stale: its watermark "
                f"{best.n_told} trails the {synced_told} synced tells by more "
                f"than one write interval ({max_lag}); skipping it and "
                "recomputing from COMPLETE trials."
            )
            return None
    _count("restore", meta={"kind": kind, "seq": best.seq, "n_told": best.n_told})
    return best


def max_slot_seq(storage: Any, study_id: int, kind: str) -> int:
    """Highest ``seq`` any decodable ring slot of ``kind`` carries — valid,
    stale, or a dead run's — or -1 when none decodes.

    A resuming (or restarted) writer continues its write counter above
    this, so newest-by-seq stays monotone across process incarnations: a
    counter restarting at 0 would lose every newest-slot race to the dead
    run's blobs. This is a peek, not a restore — defects are neither
    counted nor warned about here (``load_checkpoint`` owns that)."""
    try:
        attrs = storage.get_study_system_attrs(study_id)
    except Exception:  # graphlint: ignore[PY001] -- best-effort by contract: an unreadable ring just means "start the write counter at 0"
        return -1
    best = -1
    for slot in range(RING_SLOTS):
        blob = attrs.get(_slot_key(kind, slot))
        if not isinstance(blob, str):
            continue
        try:
            payload = unframe_snapshot(
                base64.b64decode(blob.encode("ascii"), validate=True),
                source=f"checkpoint attr {_slot_key(kind, slot)}",
            )
            record = pickle.loads(payload) if payload is not None else None
            if isinstance(record, dict):
                best = max(best, int(record.get("seq", -1)))
        except Exception:  # graphlint: ignore[PY001] -- peek only: a corrupt slot contributes no seq here and is rejected (counted, logged) by load_checkpoint
            continue
    return best


# ------------------------------------------------------------ op tokens


def op_token(run_id: int, chunk: int | str, slot: int) -> str:
    """The deterministic op token for one synced trial.

    ``run_id`` namespaces loop incarnations (a fallback resume that could
    not restore the carry starts a fresh run and must not collide with the
    dead run's tokens); ``chunk`` is the scan chunk index (or ``"s"`` for
    the Sobol startup block); ``slot`` is the in-chunk position.
    """
    return f"r{int(run_id)}:c{chunk}:{int(slot)}"


def parse_op_token(token: Any) -> tuple[int, int | None, int] | None:
    """``(run_id, chunk, slot)`` for a well-formed op token, else None.

    ``chunk`` is None for startup-block tokens (``c`` part spells ``"s"``).
    Malformed tokens — hand-edited attrs, foreign writers — parse to None
    and are treated like tokenless trials by resume accounting.
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
    """What resume learned from the trial history's op tokens."""

    #: Op tokens of finished (budget-consuming) trials.
    told: frozenset[str]
    #: Op token -> trial id for token-stamped RUNNING strays (created and
    #: stamped by a dead process, never told): adoptable by the re-run chunk.
    running: dict[str, int]
    #: Trial ids of tokenless RUNNING strays (created but never stamped):
    #: unidentifiable, reaped to FAIL at resume.
    stranded: tuple[int, ...]
    #: Highest run id any token carries (-1 when no tokens exist yet).
    max_run_id: int


def synced_ops(trials: Any) -> SyncedOps:
    """Classify a study's trials by op token for exactly-once resume.

    ``trials`` is a sequence of FrozenTrials (pass
    ``study.get_trials(deepcopy=False)``). Trials already marked
    ``ckpt:stranded`` are excluded from ``told`` — they never consumed
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


# ------------------------------------------------- fitted sampler state


def export_sampler_state(sampler: Any) -> dict[str, Any] | None:
    """A sampler's picklable fitted state via its duck-typed
    ``export_fitted_state()`` hook; None when the sampler has none (or the
    export fails — checkpoints are best-effort everywhere)."""
    hook = getattr(sampler, "export_fitted_state", None)
    if hook is None:
        return None
    try:
        return hook()
    except Exception as err:  # graphlint: ignore[PY001] -- best-effort by contract: a sampler that cannot serialize its fit must degrade to "no warm state", not fail the checkpoint write
        _logger.warning(f"export_fitted_state failed; checkpointing without it: {err!r}")
        return None


def restore_sampler_state(sampler: Any, state: Mapping[str, Any] | None) -> bool:
    """Warm-load exported fitted state into a sampler via its duck-typed
    ``restore_fitted_state(state)`` hook. True iff the sampler accepted
    it; any failure degrades to a cold fit."""
    if state is None:
        return False
    hook = getattr(sampler, "restore_fitted_state", None)
    if hook is None:
        return False
    try:
        return bool(hook(state))
    except Exception as err:  # graphlint: ignore[PY001] -- best-effort by contract: a corrupt or drifted warm state must degrade to a cold fit, not fail the hub re-home
        _logger.warning(f"restore_fitted_state failed; falling back to a cold fit: {err!r}")
        return False
