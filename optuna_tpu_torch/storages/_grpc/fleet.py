"""Hub fleet: failover-capable multi-hub suggestion serving (port of
``optuna_tpu/storages/_grpc/fleet.py``; the ring, the replay slots and the
lease records are the reference's, so either package's hubs and doctor read
the other's records).

One :class:`~optuna_tpu_torch.storages._grpc.suggest_service.SuggestService` hub
owns the server-resident sampler state for every study it serves — which
makes a single hub both the throughput ceiling and a single point of
failure. This module turns N hubs sharing ONE backing storage (the journal
every hub already mounts) into a fleet:

* **Partitioning** — :class:`FleetRouter` maps each study to its owning hub
  by consistent hashing on the study id. Clients and hubs share the same
  ring, so a mis-routed ask is *forwarded* to the owner and answered, never
  rejected (``ask_forward``).
* **Replicated serve state** — :class:`FleetReplicator` rides sampler-
  relevant serve state on the shared storage as study system attrs:
  op-token replay records for answered ``service_ask`` calls (bounded slot
  ring, same LRU spirit as the server's in-process token cache — which
  alone cannot survive a hub death) and per-hub ready-queue epoch
  watermarks. A client that redials a successor after a failover replays
  the recorded answer instead of double-dispatching (``ask_replayed``).
* **Failover** — hub liveness rides the existing health fleet channel: each
  hub publishes ``<hub>-serve`` worker snapshots
  (:data:`optuna_tpu_torch.health.HUB_WORKER_ID_SUFFIX`), staleness declares the
  hub dead (``hub_dead``; the doctor's ``service.hub_dead`` check names
  it), and the router re-homes the dead hub's studies to their ring
  successors (``hub_rehome``). The successor rebuilds its coalescer and
  ready queue lazily from the shared journal, adopting the dead hub's
  published epoch watermark so epoch semantics continue. Client-side,
  :class:`FleetClient` treats a transport-unavailable hub as
  redial-next-replica under a :class:`~optuna_tpu_torch.storages._retry.RetryPolicy`.
* **Fleet shedding** — hubs exchange SLO burn verdicts
  (``service_burn_verdict``, scored by :func:`optuna_tpu_torch.slo.burn_score`)
  so an overloaded hub forwards an ask to the least-burning alive peer one
  rung before shedding to the client (``shed_forward``); only a fleet-wide
  burst walks the client-visible shed ladder.
* **Lease-fenced ownership** — liveness alone cannot stop a
  *zombie*: a hub declared dead (partition, GC/SIGSTOP pause) that is still
  alive and still writing. A hub's claim on a study is therefore an
  epoch-numbered lease persisted as the ``lease:study:<id>`` system attr
  (:class:`StudyLeases`); a successor's re-home bumps the epoch, and every
  serve-state write from a hub (replay records, epoch watermarks,
  ``ckpt:hub`` blobs) carries and is checked against its fencing epoch by
  :class:`LeaseFencedStorage` — a stale-epoch write raises the typed
  :class:`~optuna_tpu_torch.exceptions.StaleLeaseError` and the zombie
  self-demotes (drains asks toward the lease owner, never aborts a
  client). When the ring prefers the deposed hub again (the partition
  healed, or the interim owner died) it *fails back* by re-acquiring with
  a further epoch bump, so ownership converges instead of flapping.

The event vocabulary is :data:`FLEET_EVENTS`, equal to the chaos matrix
``testing/fault_injection.py::HUB_CHAOS_MATRIX``; each event increments the
``serve.fleet.<event>`` telemetry counter family. The lease/fence
vocabulary is :data:`LEASE_EVENTS`, equal to
``testing/fault_injection.py::LEASE_CHAOS_MATRIX``; lease events count as
``fleet.lease.<event>`` except the rejected write itself, which counts as
the loud ``fleet.fenced_write``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from bisect import bisect_right
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

from optuna_tpu_torch import flight, locksan, telemetry
from optuna_tpu_torch import checkpoint as _ckpt
from optuna_tpu_torch.exceptions import StaleLeaseError
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.samplers._resilience import is_device_fault
from optuna_tpu_torch.storages._base import _ForwardingStorage
from optuna_tpu_torch.storages._retry import RetryPolicy, TransientStorageError

if TYPE_CHECKING:
    from optuna_tpu_torch.storages._base import BaseStorage
    from optuna_tpu_torch.storages._grpc.suggest_service import SuggestService

_logger = get_logger(__name__)


#: The fleet event vocabulary: every cross-hub decision the fleet layer can
#: take, each counted as ``serve.fleet.<event>`` and each forced by a chaos
#: scenario: the tests fail if this copy and the chaos matrix in
#: ``testing/fault_injection.py::HUB_CHAOS_MATRIX`` drift apart.
FLEET_EVENTS: dict[str, str] = {
    "hub_dead": "a hub's -serve health snapshot went stale past grace: the router stops routing to it",
    "hub_rehome": "a dead hub's study was adopted by its ring successor, which rebuilds serve state from the shared journal",
    "ask_forward": "an ask was forwarded to a peer hub (mis-route to the owner, or overload to the least-burning peer)",
    "ask_replayed": "a redialed ask was answered from the shared replay record instead of re-executing (exactly-once across failover)",
    "shed_forward": "an overloaded hub forwarded an ask to the least-burning peer one rung before shedding to the client",
}

#: Flight-recorder flow name for the cross-hub forward arrow (``out`` on the
#: forwarding hub, ``in`` on the answering hub — one arrow per forwarded ask
#: in Perfetto).
FORWARD_FLOW = "fleet.ask.forward"

#: Replay-record slot count per study. Records live in a fixed ring of study
#: system attrs (``serve:fleet:tok:<slot>``) so the shared storage holds a
#: bounded replay memory per study — enough to cover any plausible redial
#: window, overwritten (not grown) under sustained traffic.
REPLAY_SLOTS = 256

_TOKEN_ATTR_PREFIX = "serve:fleet:tok:"
_WATERMARK_ATTR_PREFIX = "serve:fleet:wm:"

#: The lease/fence event vocabulary: every ownership transition the lease
#: layer can take, each forced by a chaos scenario. Counted as
#: ``fleet.lease.<event>`` — except ``fenced_write``, whose counter is the
#: loud standalone ``fleet.fenced_write`` the chaos acceptance asserts
#: exactly. The tests fail if this copy and the chaos matrix in
#: ``testing/fault_injection.py::LEASE_CHAOS_MATRIX`` drift apart.
LEASE_EVENTS: dict[str, str] = {
    "acquire": "a hub claimed an unleased study: epoch 1, the fence baseline every later takeover bumps past",
    "renew": "the lease owner re-asserted its claim at the adaptive renewal cadence (read-check-then-write, injectable clock)",
    "takeover": "a successor (re-home) or the returning ring primary (failback) bumped the epoch and displaced the recorded owner",
    "demote": "a hub observed its claim was stale (fence trip or renewal check) and stopped writing serve state for the study",
    "fenced_write": "a stale-epoch serve-state write was rejected by the lease fence with a typed StaleLeaseError",
}

#: Study-lease system-attr prefix; the full key is
#: ``lease:study:<study_id>`` (self-describing — the record also names its
#: owner and epoch, so a journal tail is readable without the key).
LEASE_ATTR_PREFIX = "lease:study:"

#: Default lease time-to-live. A lease is *expired* once its age exceeds
#: ``grace_factor x ttl_s`` — the same adaptive-grace discipline hub
#: liveness applies to slow health publishers
#: (:data:`optuna_tpu_torch.health.LIVENESS_GRACE_FACTOR`), so a slow renewer is
#: not deposed by one missed beat.
DEFAULT_LEASE_TTL_S = 15.0

#: Ownership transitions kept on the lease record itself (newest last):
#: the evidence trail the doctor's ``service.hub_flapping`` /
#: ``service.partition_suspected`` checks read.
LEASE_HISTORY_LIMIT = 8


def lease_attr_key(study_id: int) -> str:
    return f"{LEASE_ATTR_PREFIX}{study_id}"


def read_lease(storage: "BaseStorage", study_id: int) -> dict | None:
    """The persisted lease record for a study (None when unleased).
    Shape: ``{"owner", "epoch", "ttl_s", "granted_unix", "renewed_unix",
    "history": [{"owner", "epoch", "unix"}, ...]}``."""
    lease = storage.get_study_system_attrs(study_id).get(lease_attr_key(study_id))
    return dict(lease) if isinstance(lease, Mapping) else None


def _count_lease_event(event: str, meta: dict | None = None) -> None:
    name = "fleet.fenced_write" if event == "fenced_write" else f"fleet.lease.{event}"
    telemetry.count(name, meta=meta)


class HubUnavailableError(TransientStorageError):
    """A fleet hub cannot be reached (dead, partitioned, or draining away):
    safe to redial the next replica — the op token dedupes any ask the dead
    hub already committed."""


# ---------------------------------------------------------------- router


class FleetRouter:
    """Consistent-hash ring mapping study ids to hubs.

    Every participant (thin clients, every hub) builds the ring from the
    same hub list, so ownership is a pure function of the study id — no
    coordination service. ``replicas`` virtual points per hub keep the
    partition sizes balanced; the ring is deterministic (SHA-1, no process
    randomness) so two processes never disagree about an owner.
    """

    def __init__(self, hubs: Sequence[str], *, replicas: int = 64) -> None:
        if not hubs:
            raise ValueError("a fleet needs at least one hub.")
        if len(set(hubs)) != len(hubs):
            raise ValueError(f"duplicate hub names in {list(hubs)!r}.")
        self.hubs: tuple[str, ...] = tuple(hubs)
        self.replicas = int(replicas)
        ring: list[tuple[int, str]] = []
        for hub in self.hubs:
            for i in range(self.replicas):
                ring.append((self._point(f"{hub}#{i}"), hub))
        ring.sort()
        self._ring = ring
        self._points = [point for point, _ in ring]

    @staticmethod
    def _point(key: str) -> int:
        return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")

    def successors(self, study_id: int) -> tuple[str, ...]:
        """Every hub, in ring order from the study's point: the owner first,
        then each distinct failover successor. Walking this order is the
        whole re-homing contract — clients redial along it, hubs adopt
        along it, and both ends agree without talking to each other."""
        start = bisect_right(self._points, self._point(f"study:{study_id}"))
        seen: list[str] = []
        n = len(self._ring)
        for k in range(n):
            hub = self._ring[(start + k) % n][1]
            if hub not in seen:
                seen.append(hub)
                if len(seen) == len(self.hubs):
                    break
        return tuple(seen)

    def hub_for(self, study_id: int) -> str:
        """The study's primary owner (ignores liveness)."""
        return self.successors(study_id)[0]

    def route(self, study_id: int, alive: "frozenset[str] | set[str] | None" = None) -> str:
        """The hub that should answer the study right now: the first ring
        successor in ``alive`` — which is the owner while it lives, and its
        successor once the owner is declared dead (re-homing is just this
        walk). With every hub dead (or no liveness view), the primary owner
        answers: a wrong guess degrades to a redial, never to silence."""
        if alive is None:
            return self.hub_for(study_id)
        for hub in self.successors(study_id):
            if hub in alive:
                return hub
        return self.hub_for(study_id)


# ------------------------------------------------------------- liveness


def dead_hubs(
    storage: "BaseStorage",
    study_id: int,
    hubs: Sequence[str],
    *,
    now: float | None = None,
) -> frozenset[str]:
    """Hubs declared dead by the health fleet channel for this study: their
    ``<hub>-serve`` worker snapshot exists, is not a clean-exit ``final``
    flush, and has aged past the liveness grace. A hub with *no* snapshot
    here is unknown, not dead — only a declared death re-homes (optimistic
    routing; a wrong guess is absorbed by the client's redial loop)."""
    from optuna_tpu_torch import health

    now = time.time() if now is None else now
    suffix = health.HUB_WORKER_ID_SUFFIX
    dead: set[str] = set()
    for worker_id, snap in health.worker_snapshots(storage, study_id).items():
        if not worker_id.endswith(suffix):
            continue
        hub = worker_id[: -len(suffix)]
        if hubs and hub not in hubs:
            continue
        if bool(snap.get("final")):
            continue  # clean exit: drained away, not dead
        interval = float(snap.get("interval_s") or health.DEFAULT_INTERVAL_S)
        age = now - float(snap.get("last_seen_unix", 0.0))
        if age > health.LIVENESS_GRACE_FACTOR * interval:
            dead.add(hub)
    return frozenset(dead)


# ----------------------------------------------------------- replicator


class FleetReplicator:
    """Serve state that must survive a hub death, riding the storage every
    hub shares (the journal): op-token replay records and per-hub
    ready-queue epoch watermarks.

    Replay records live in a fixed ring of :data:`REPLAY_SLOTS` study attrs
    keyed by a hash of the token — one overwrite-in-place storage write per
    answered ask, bounded memory, last-writer-wins (each token is written by
    exactly one answering hub). Lookup is one attrs read, paid only on
    *redialed* asks (the client marks them), never on the hot path.
    """

    def __init__(
        self, storage: "BaseStorage", *, now: Callable[[], float] = time.time
    ) -> None:
        self._storage = storage
        self._now = now

    @staticmethod
    def _slot(token: str) -> int:
        return int.from_bytes(hashlib.sha1(token.encode()).digest()[:4], "big") % (
            REPLAY_SLOTS
        )

    def record_ask(
        self, study_id: int, token: str, resp: Mapping[str, Any], *, fence: int = 0
    ) -> None:
        try:
            self._storage.set_study_system_attr(
                study_id,
                f"{_TOKEN_ATTR_PREFIX}{self._slot(token)}",
                {
                    "token": token,
                    "resp": dict(resp),
                    "fence": int(fence),
                    "ts": self._now(),
                },
            )
        except StaleLeaseError:
            # The fence already counted the rejection (fleet.fenced_write)
            # and demoted this hub before raising: a zombie's replay record
            # simply does not land, quietly.
            _logger.info(f"fleet replay record for study {study_id} fenced.")
        except Exception as err:  # graphlint: ignore[PY001] -- replication is best-effort durability: the ask was answered; a record write blip must not fail it (the uncovered window equals today's single-hub behavior)
            _logger.warning(f"fleet replay record for study {study_id} raised {err!r}.")

    def lookup_ask(self, study_id: int, token: str) -> dict | None:
        try:
            attrs = self._storage.get_study_system_attrs(study_id)
        except Exception as err:  # graphlint: ignore[PY001] -- lookup is an optimization over re-executing; a read blip falls back to a fresh (still correct, op-token-deduped locally) execution
            _logger.warning(f"fleet replay lookup for study {study_id} raised {err!r}.")
            return None
        record = attrs.get(f"{_TOKEN_ATTR_PREFIX}{self._slot(token)}")
        if isinstance(record, Mapping) and record.get("token") == token:
            resp = record.get("resp")
            return dict(resp) if isinstance(resp, Mapping) else None
        if isinstance(record, Mapping) and "ts" in record:
            # The slot was overwritten by a different token. If the
            # overwrite is younger than the retry window, the record this
            # redial needed may have been evicted while its client could
            # still legally redial — the silent-re-execution hazard the
            # op-token eviction hardening makes loud: the redialed ask now re-executes instead of replaying
            # (still deduped by the answering hub's in-process token cache
            # when it survived, but no longer across a hub death).
            from optuna_tpu_torch.storages._grpc.client import OP_TOKEN_REPLAY_WINDOW_S

            age = self._now() - float(record.get("ts") or 0.0)
            if 0.0 <= age < OP_TOKEN_REPLAY_WINDOW_S:
                telemetry.count(
                    "grpc.op_token_evicted_live",
                    meta={"layer": "fleet", "slot": self._slot(token)},
                )
                _logger.warning(
                    f"fleet replay slot for study {study_id} was overwritten "
                    f"{age:.1f}s ago (< {OP_TOKEN_REPLAY_WINDOW_S:.0f}s retry "
                    f"window): a live replay record was evicted; the redial "
                    f"re-executes."
                )
        return None

    def record_watermark(
        self, study_id: int, hub: str, *, epoch: int, asks: int = 0, fence: int = 0
    ) -> None:
        try:
            self._storage.set_study_system_attr(
                study_id,
                _WATERMARK_ATTR_PREFIX + hub,
                {
                    "hub": hub,
                    "epoch": int(epoch),
                    "asks": int(asks),
                    "fence": int(fence),
                    "ts": self._now(),
                },
            )
        except StaleLeaseError:
            # See record_ask: counted and demoted at the fence already.
            _logger.info(f"fleet watermark for study {study_id} fenced.")
        except Exception as err:  # graphlint: ignore[PY001] -- same best-effort contract as record_ask: a missed watermark means a successor starts one epoch behind, which the invalidation machinery already tolerates
            _logger.warning(f"fleet watermark for study {study_id} raised {err!r}.")

    def watermark_epoch(self, study_id: int) -> int:
        """The highest ready-queue epoch any hub published for this study
        (0 when none): the floor a successor adopts so its epoch semantics
        continue the dead hub's instead of restarting at 0."""
        try:
            attrs = self._storage.get_study_system_attrs(study_id)
        except Exception as err:  # graphlint: ignore[PY001] -- see lookup_ask: absence degrades to epoch 0, the fresh-hub behavior
            _logger.warning(f"fleet watermark read for study {study_id} raised {err!r}.")
            return 0
        epoch = 0
        for key, value in attrs.items():
            if key.startswith(_WATERMARK_ATTR_PREFIX) and isinstance(value, Mapping):
                try:
                    epoch = max(epoch, int(value.get("epoch", 0)))
                except (TypeError, ValueError):
                    continue
        return epoch


# --------------------------------------------------------------- leases


class StudyLeases:
    """Epoch-numbered study-ownership leases persisted through the shared
    storage (``lease:study:<id>`` system attr).

    The epoch is the write fence: it only ever goes up (every ownership
    transition bumps it), a hub's serve-state writes are valid only while
    the persisted record still names this hub at the epoch it holds, and a
    losing racer discovers the loss on its next fence check or renewal —
    last-writer-wins storage is enough, no CAS needed, because two racers
    writing the same epoch still disagree on ``owner`` and exactly one of
    them fails the owner comparison.

    Renewal is read-check-then-write on the injectable clock (the
    ``RetryPolicy`` discipline): at most one storage round-trip per
    ``ttl_s / 2`` per study, and the read half doubles as the stale-claim
    detector. Fence checks cache the persisted view for ``check_ttl_s``
    (0 → read-through, the chaos tests' deterministic mode; the default
    amortizes the read the same way hub liveness does).
    """

    def __init__(
        self,
        storage: "BaseStorage",
        owner: str,
        *,
        ttl_s: float = DEFAULT_LEASE_TTL_S,
        grace_factor: float | None = None,
        check_ttl_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        now: Callable[[], float] = time.time,
    ) -> None:
        from optuna_tpu_torch import health

        self._storage = storage
        self.owner = owner
        self.ttl_s = float(ttl_s)
        self.grace_factor = float(
            health.LIVENESS_GRACE_FACTOR if grace_factor is None else grace_factor
        )
        self.check_ttl_s = float(check_ttl_s)
        self._clock = clock
        self._now = now
        self._lock = locksan.lock("fleet.lease")
        #: study_id -> epoch this hub holds (locally; the fence compares it
        #: against the persisted record).
        self._held: dict[int, int] = {}
        #: study_id -> monotonic deadline of the next renewal.
        self._next_renew: dict[int, float] = {}
        #: study_id -> (expires_monotonic, persisted_epoch, persisted_owner).
        self._fence_cache: dict[int, tuple[float, int, str]] = {}

    # ------------------------------------------------------------- record

    def read(self, study_id: int) -> dict | None:
        return read_lease(self._storage, study_id)

    def expired(self, lease: Mapping[str, Any], *, now: float | None = None) -> bool:
        """A lease whose renewal age exceeds the grace window: safe for any
        successor to take over without a liveness verdict. A released lease
        (``renewed_unix == 0``) is immediately expired — the clean-drain
        handoff path."""
        now = self._now() if now is None else now
        renewed = float(lease.get("renewed_unix", 0.0))
        ttl = float(lease.get("ttl_s", self.ttl_s)) or self.ttl_s
        return now - renewed > self.grace_factor * ttl

    def held_epoch(self, study_id: int) -> int:
        with self._lock:
            return self._held.get(study_id, 0)

    def _write(self, study_id: int, record: dict) -> None:
        # Storage write outside the lock (CONC002); the local tables update
        # after the write lands so a failed write never fabricates a claim.
        self._storage.set_study_system_attr(
            study_id, lease_attr_key(study_id), record
        )
        with self._lock:
            self._held[study_id] = int(record["epoch"])
            self._next_renew[study_id] = self._clock() + self.ttl_s / 2.0
            self._fence_cache[study_id] = (
                self._clock() + self.check_ttl_s,
                int(record["epoch"]),
                str(record["owner"]),
            )

    # ---------------------------------------------------------- lifecycle

    def acquire(self, study_id: int, *, takeover: bool = False) -> int:
        """Claim (or re-assert) the study. Returns the held epoch, or 0 when
        another owner's valid lease stands and ``takeover`` was not
        requested. ``takeover=True`` is the re-home/failback path: bump the
        epoch past the recorded owner's — its in-flight writes are fenced
        from this moment on."""
        current = self.read(study_id)
        now = self._now()
        history = list(current.get("history") or []) if current else []
        if current is None:
            epoch, event = 1, "acquire"
            granted = now
        elif current.get("owner") == self.owner:
            epoch = int(current.get("epoch", 0)) or 1
            event = None  # refresh of an existing claim, not a transition
            granted = float(current.get("granted_unix", now))
        elif takeover or self.expired(current, now=now):
            epoch = int(current.get("epoch", 0)) + 1
            event = "takeover"
            granted = now
        else:
            return 0
        if event is not None:
            history.append({"owner": self.owner, "epoch": epoch, "unix": now})
            history = history[-LEASE_HISTORY_LIMIT:]
        self._write(
            study_id,
            {
                "owner": self.owner,
                "epoch": epoch,
                "ttl_s": self.ttl_s,
                "granted_unix": granted,
                "renewed_unix": now,
                "history": history,
            },
        )
        if event is not None:
            _count_lease_event(
                event, meta={"study": study_id, "owner": self.owner, "epoch": epoch}
            )
        return epoch

    def tick(self, study_id: int) -> int:
        """Hot-path upkeep: returns the held epoch (0 = no claim) and, when
        the adaptive renewal cadence is due, re-reads and re-asserts the
        lease — raising :class:`StaleLeaseError` if it was taken over. The
        not-due path is two dict reads and a clock compare: no storage
        traffic, no allocations."""
        with self._lock:
            held = self._held.get(study_id, 0)
            due = held > 0 and self._clock() >= self._next_renew.get(study_id, 0.0)
        if due:
            self._renew(study_id, held)
        return held

    def _renew(self, study_id: int, held: int) -> None:
        current = self.read(study_id)
        now = self._now()
        if current is not None:
            epoch = int(current.get("epoch", 0))
            owner = current.get("owner")
            if epoch > held or (epoch >= held and owner != self.owner):
                raise StaleLeaseError(
                    study_id, held_epoch=held, fence_epoch=epoch, owner=owner
                )
        record = dict(current) if current is not None else {
            "owner": self.owner,
            "epoch": held,
            "ttl_s": self.ttl_s,
            "granted_unix": now,
            "history": [{"owner": self.owner, "epoch": held, "unix": now}],
        }
        record["renewed_unix"] = now
        self._write(study_id, record)
        _count_lease_event(
            "renew", meta={"study": study_id, "owner": self.owner, "epoch": held}
        )

    def check_fence(self, study_id: int) -> int:
        """The write fence: a no-op for unleased studies (epoch 0 — the
        pre-lease legacy write path a spill peer or solo hub takes), else
        compares the held epoch against the persisted record (cached for
        ``check_ttl_s``) and raises :class:`StaleLeaseError` when the claim
        is stale. A read blip passes the write through — availability over
        strictness, matching every other best-effort serve-state path."""
        with self._lock:
            held = self._held.get(study_id, 0)
            if held == 0:
                return 0
            cached = self._fence_cache.get(study_id)
            fresh = cached if cached is not None and self._clock() < cached[0] else None
        if fresh is None:
            try:
                current = self.read(study_id)
            except Exception as err:  # graphlint: ignore[PY001] -- a fence that cannot read must not block the write: the uncovered window equals today's pre-lease behavior, and the next readable check re-arms it
                _logger.warning(
                    f"lease fence read for study {study_id} raised {err!r}; "
                    f"write passed unfenced."
                )
                return held
            epoch = int(current.get("epoch", held)) if current else held
            owner = str((current or {}).get("owner", self.owner))
            with self._lock:
                self._fence_cache[study_id] = (
                    self._clock() + self.check_ttl_s, epoch, owner
                )
        else:
            epoch, owner = fresh[1], fresh[2]
        if epoch > held or (epoch == held and owner != self.owner):
            raise StaleLeaseError(
                study_id, held_epoch=held, fence_epoch=epoch, owner=owner
            )
        return held

    def release(self, study_id: int) -> None:
        """Clean handoff (drain/close): mark the persisted record released
        (``renewed_unix = 0`` — instantly expired) so a successor takes over
        without waiting out the grace window. The local epoch stays held:
        any write this hub still attempts remains fence-checked."""
        current = self.read(study_id)
        if current is None or current.get("owner") != self.owner:
            return
        record = dict(current)
        record["renewed_unix"] = 0.0
        record["released"] = True
        self._storage.set_study_system_attr(
            study_id, lease_attr_key(study_id), record
        )

    def release_all(self) -> None:
        with self._lock:
            held = list(self._held)
        for study_id in held:
            try:
                self.release(study_id)
            except Exception as err:  # graphlint: ignore[PY001] -- release is a courtesy to the successor (skip the grace wait); a drain must complete even when the shared storage is already gone
                _logger.warning(
                    f"lease release for study {study_id} raised {err!r}."
                )

    def invalidate(self, study_id: int | None = None) -> None:
        """Drop the cached fence view (the chaos kit flips ownership
        mid-burst; real traffic just waits out ``check_ttl_s``)."""
        with self._lock:
            if study_id is None:
                self._fence_cache.clear()
            else:
                self._fence_cache.pop(study_id, None)


class LeaseFencedStorage(_ForwardingStorage):
    """The hub-side storage stack's fence (the storage layer that rejects
    stale-epoch writes): wraps the storage a hub writes its serve state
    through and checks the lease fence on every serve-state study attr —
    replay records (``serve:fleet:tok:*``), epoch watermarks
    (``serve:fleet:wm:*``), and checkpoints (``ckpt:*``). A stale claim
    raises the typed :class:`StaleLeaseError`, counts the loud
    ``fleet.fenced_write``, and notifies the hub's demotion ladder — the
    write never reaches the backing storage.

    Everything else passes through untouched: client-originated writes ride
    the *mounted* storage (a different wrapper entirely), health snapshots
    must keep flowing from a zombie (that is how flapping stays
    observable), and the hub's per-trial fallback-diagnostics attr is
    single-writer by construction (only the hub that answered that trial's
    ask ever writes it), so none of them are split-brain hazards.
    """

    _FENCED_STUDY_PREFIXES = (
        _TOKEN_ATTR_PREFIX,
        _WATERMARK_ATTR_PREFIX,
        _ckpt.CKPT_ATTR_PREFIX,
    )

    def __init__(
        self,
        inner: "BaseStorage",
        leases: StudyLeases,
        *,
        on_fenced: Callable[[int, StaleLeaseError], None] | None = None,
    ) -> None:
        super().__init__(inner)
        self._leases = leases
        self._on_fenced = on_fenced

    def __getattr__(self, name: str) -> Any:
        # Backend-specific extras beyond the BaseStorage surface (e.g. the
        # proxy's incremental-read hook) must keep flowing through the fence.
        return getattr(object.__getattribute__(self, "_backend"), name)

    def fence_epoch(self, study_id: int) -> int:
        """The epoch this hub's writes carry for the study (0 = unleased):
        what ``_write_hub_checkpoint`` stamps into the ``ckpt:hub`` frame."""
        return self._leases.held_epoch(study_id)

    def set_study_system_attr(self, study_id: int, key: str, value: Any) -> None:
        if key.startswith(self._FENCED_STUDY_PREFIXES):
            try:
                self._leases.check_fence(study_id)
            except StaleLeaseError as err:
                _count_lease_event(
                    "fenced_write",
                    meta={
                        "study": study_id,
                        "key": key,
                        "held": err.held_epoch,
                        "fence": err.fence_epoch,
                    },
                )
                if self._on_fenced is not None:
                    self._on_fenced(study_id, err)
                raise
        return self._backend.set_study_system_attr(study_id, key, value)


# ------------------------------------------------------------------ hub


class FleetHub:
    """One fleet member: wraps a :class:`SuggestService` and IS the
    ``suggest_service`` the gRPC server mounts (same duck type — the
    handler dispatches suggest methods by name; everything else delegates
    to the inner service).

    ``peers`` maps hub name -> a peer object exposing
    ``service_forwarded_ask(...)`` and ``service_burn_verdict()`` — in
    process (the :class:`~optuna_tpu_torch.testing.fault_injection.FakeHubFleet`
    hands hubs each other directly) or over sockets
    (:func:`remote_peers`). The hub's own name must be a router member.
    """

    def __init__(
        self,
        name: str,
        service: "SuggestService",
        router: FleetRouter,
        storage: "BaseStorage",
        *,
        peers: Mapping[str, Any] | None = None,
        liveness_ttl_s: float = 1.0,
        lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
        lease_check_ttl_s: float = 1.0,
        leases: StudyLeases | None = None,
        clock: Callable[[], float] = time.monotonic,
        now: Callable[[], float] = time.time,
    ) -> None:
        if name not in router.hubs:
            raise ValueError(f"hub {name!r} is not on the router ring {router.hubs}.")
        self.name = name
        self.service = service
        if getattr(service, "_health_worker_id", None) is None:
            # The hub's snapshots must be tellable apart from its peers'
            # (liveness is derived per hub name), so a fleet member
            # publishes under its own name unless the caller already chose.
            from optuna_tpu_torch import health

            service._health_worker_id = name + health.HUB_WORKER_ID_SUFFIX
        self.router = router
        self._storage = storage
        if len(router.hubs) == 1:
            # A fleet of one has no successor to fence against: skip the
            # lease machinery entirely so the solo twin stays write-for-write
            # identical to a bare single hub (no lease attrs, no extra reads).
            self.leases: StudyLeases | None = None
            self.replicator = FleetReplicator(storage, now=now)
        else:
            self.leases = (
                leases
                if leases is not None
                else StudyLeases(
                    storage,
                    name,
                    ttl_s=lease_ttl_s,
                    check_ttl_s=lease_check_ttl_s,
                    clock=clock,
                    now=now,
                )
            )
            # Single enforcement point for every serve-state write this hub
            # originates: the service's own (ckpt:hub blobs via note_tell's
            # checkpoint cadence) and the replicator's (replay records,
            # epoch watermarks) both flow through the lease fence. Lease
            # records themselves ride the RAW storage — displacing a zombie
            # must never be blocked by the zombie's own stale claim. A
            # service double without a storage (liveness-only harnesses)
            # originates no serve-state writes, so it has nothing to fence.
            if hasattr(service, "_storage"):
                service._storage = LeaseFencedStorage(
                    service._storage, self.leases, on_fenced=self._on_fenced
                )
            self.replicator = FleetReplicator(
                LeaseFencedStorage(storage, self.leases, on_fenced=self._on_fenced),
                now=now,
            )
        #: study_id -> usurping owner name ("" when unknown) once a fence
        #: trip demoted this hub for the study; cleared on failback.
        self._fenced_studies: dict[int, str] = {}
        self._peers: dict[str, Any] = dict(peers or {})
        self._liveness_ttl_s = float(liveness_ttl_s)
        self._clock = clock
        self._now = now
        self._liveness_lock = locksan.lock("fleet.liveness")
        #: study_id -> (expires_at, alive frozenset) — liveness is a storage
        #: read; cache it so the hot ask path pays one read per TTL, not one
        #: per ask.
        self._liveness_cache: dict[int, tuple[float, frozenset[str]]] = {}
        #: Hubs already counted/logged dead (the hub_dead event fires once
        #: per death, not once per ask that observes it).
        self._known_dead: set[str] = set()
        #: Studies whose epoch watermark this hub already adopted.
        self._adopted: set[int] = set()
        self._adopt_lock = locksan.lock("fleet.adopt")
        #: study_id -> last epoch this hub published a watermark for.
        self._published_epochs: dict[int, int] = {}

    # ------------------------------------------------------------ plumbing

    def __getattr__(self, name: str) -> Any:
        # Everything the server/tests call on a suggest service that the
        # fleet layer does not intercept (wrap_storage, drain, close,
        # note_tell, prewarm, refill_now, state, shed_policy, ...).
        return getattr(self.service, name)

    @property
    def solo(self) -> bool:
        """A fleet of one: no successor exists, so replication writes are
        skipped — the fault-free fleet-of-1 twin is the single hub, bit for
        bit and write for write."""
        return len(self.router.hubs) == 1

    def set_peer(self, name: str, peer: Any) -> None:
        self._peers[name] = peer

    def drain(self) -> None:
        """Clean shutdown: drain the wrapped service first (every parked ask
        gets its verdict), then release every held lease — a released lease
        is instantly expired, so successors take over without waiting out
        the grace window."""
        self.service.drain()
        if self.leases is not None:
            self.leases.release_all()

    # ------------------------------------------------------------ liveness

    def alive_hubs(self, study_id: int) -> frozenset[str]:
        with self._liveness_lock:
            cached = self._liveness_cache.get(study_id)
            if cached is not None and self._clock() < cached[0]:
                return cached[1]
        dead = dead_hubs(self._storage, study_id, self.router.hubs, now=self._now())
        alive = frozenset(self.router.hubs) - dead
        with self._liveness_lock:
            self._liveness_cache[study_id] = (self._clock() + self._liveness_ttl_s, alive)
            fresh_deaths = dead - self._known_dead
            self._known_dead |= dead
        for hub in sorted(fresh_deaths):
            telemetry.count("serve.fleet.hub_dead", meta={"hub": hub, "seen_by": self.name})
            _logger.warning(
                f"fleet hub {hub!r} declared dead (stale -serve snapshot); "
                f"its studies re-home to ring successors."
            )
        return alive

    def invalidate_liveness(self, study_id: int | None = None) -> None:
        """Drop the cached liveness view (tests and the chaos kit flip
        liveness mid-burst; real traffic just waits out the TTL)."""
        with self._liveness_lock:
            if study_id is None:
                self._liveness_cache.clear()
            else:
                self._liveness_cache.pop(study_id, None)
        if self.leases is not None:
            # Ownership and liveness flip together in the chaos kit: a hub
            # told liveness changed should re-read the lease fence too.
            self.leases.invalidate(study_id)

    # ----------------------------------------------------------------- ask

    def service_ask(
        self,
        study_id: int,
        trial_id: int,
        trial_number: int,
        op_token: str | None = None,
        fleet_redial: bool = False,
    ) -> dict:
        """The fleet ask path: replay lookup (redials only), mis-route
        forwarding to the owner, local answer, overload forwarding to the
        least-burning peer, replication record — in that order."""
        if fleet_redial and op_token is not None and not self.solo:
            replay = self.replicator.lookup_ask(study_id, op_token)
            if replay is not None:
                telemetry.count(
                    "serve.fleet.ask_replayed",
                    meta={"hub": self.name, "trial": trial_number},
                )
                return replay
        alive = self.alive_hubs(study_id) if not self.solo else frozenset(self.router.hubs)
        owner = self.router.route(study_id, alive)
        if owner != self.name and owner in self._peers:
            # Mis-routed (or re-homed elsewhere): answer by forwarding, not
            # by rejecting — the client keeps its one-RPC contract.
            resp = self._forward(owner, study_id, trial_id, trial_number, op_token)
            if resp is not None:
                return resp
            # The owner was unreachable: answer locally (this hub becomes
            # the de-facto successor until liveness catches up).
            self.invalidate_liveness(study_id)
        return self._local_ask(study_id, trial_id, trial_number, op_token, alive)

    def service_forwarded_ask(
        self,
        study_id: int,
        trial_id: int,
        trial_number: int,
        op_token: str | None = None,
        flow: str | None = None,
        src: str | None = None,
    ) -> dict:
        """A peer hub's forwarded ask: close the cross-hub flow arrow and
        answer locally — never forward again (one hop bounds the walk)."""
        if flow is not None and flight.enabled():
            flight.flow(
                FORWARD_FLOW, flow, "in",
                trial=trial_number, meta={"from": src, "to": self.name},
            )
        alive = self.alive_hubs(study_id) if not self.solo else frozenset(self.router.hubs)
        return self._local_ask(study_id, trial_id, trial_number, op_token, alive)

    def _local_ask(
        self,
        study_id: int,
        trial_id: int,
        trial_number: int,
        op_token: str | None,
        alive: frozenset[str],
    ) -> dict:
        self._adopt(study_id, alive)
        self._ensure_lease(study_id, alive)
        demoted_to = self._demoted_for(study_id)
        if demoted_to is not None:
            return self._drain_to_owner(
                demoted_to, study_id, trial_id, trial_number, op_token, alive
            )
        resp = self.service.service_ask(study_id, trial_id, trial_number)
        if resp.get("shed") == "reject":
            forwarded = self._shed_forward(study_id, trial_id, trial_number, op_token, alive)
            if forwarded is not None:
                resp = forwarded
        if (
            op_token is not None
            and not self.solo
            and resp.get("shed") != "reject"
        ):
            fence = self.leases.held_epoch(study_id) if self.leases is not None else 0
            self.replicator.record_ask(study_id, op_token, resp, fence=fence)
        self._publish_watermark(study_id)
        return resp

    # -------------------------------------------------------------- leases

    def _ensure_lease(self, study_id: int, alive: frozenset[str]) -> None:
        """Lease upkeep on the local answer path. Ring-preferred and
        unleased → acquire (bumping past any recorded owner: the re-home
        path). Already leased → tick (renewal at the adaptive cadence; a
        stale claim surfaces here as :class:`StaleLeaseError` → demotion).
        Demoted but ring-preferred again → *failback*: re-acquire with a
        further epoch bump — the interim owner's next check demotes it, so
        ownership converges on the ring's preference instead of flapping.
        Not preferred and unleased → answer unfenced (epoch 0): the
        spill-peer path, whose writes were always best-effort."""
        if self.leases is None:
            return
        preferred = self.router.route(study_id, alive) == self.name
        try:
            with self._adopt_lock:
                demoted = study_id in self._fenced_studies
            if demoted:
                if preferred:
                    self.leases.acquire(study_id, takeover=True)
                    with self._adopt_lock:
                        self._fenced_studies.pop(study_id, None)
                return
            if self.leases.held_epoch(study_id) > 0:
                self.leases.tick(study_id)
            elif preferred:
                self.leases.acquire(study_id, takeover=True)
        except StaleLeaseError as err:
            self._on_fenced(study_id, err)
        except Exception as err:  # graphlint: ignore[PY001] -- lease upkeep must never fail an ask: an unreadable lease record leaves this hub on the unfenced epoch-0 path, exactly the pre-lease behavior, until the record reads again
            _logger.warning(
                f"lease upkeep for study {study_id} on hub {self.name!r} "
                f"raised {err!r}."
            )

    def _on_fenced(self, study_id: int, err: StaleLeaseError) -> None:
        """Fence trip → self-demotion: remember the usurper (asks drain
        toward it), count the demotion once per episode, and invalidate the
        ready queue so no parked proposal minted under the lost claim is
        ever served."""
        with self._adopt_lock:
            already = study_id in self._fenced_studies
            self._fenced_studies[study_id] = err.owner or ""
        if already:
            return
        _count_lease_event(
            "demote",
            meta={
                "study": study_id,
                "hub": self.name,
                "owner": err.owner,
                "held": err.held_epoch,
                "fence": err.fence_epoch,
            },
        )
        _logger.warning(
            f"hub {self.name!r} demoted for study {study_id}: its lease "
            f"epoch {err.held_epoch} is fenced by epoch {err.fence_epoch} "
            f"(owner {err.owner!r}); asks drain toward the owner."
        )
        handle = self.service._handles.get(study_id)
        if handle is not None:
            handle.queue.invalidate()

    def _demoted_for(self, study_id: int) -> str | None:
        """The usurping owner to drain toward while demoted ("" when the
        fence could not name one), or None when not demoted."""
        if self.leases is None:
            return None
        with self._adopt_lock:
            if study_id not in self._fenced_studies:
                return None
            return self._fenced_studies[study_id]

    def _drain_to_owner(
        self,
        owner: str,
        study_id: int,
        trial_id: int,
        trial_number: int,
        op_token: str | None,
        alive: frozenset[str],
    ) -> dict:
        """The self-demotion ladder: a fence-tripped hub hands asks to the
        lease owner — forwarded when the owner is a reachable peer, else a
        redial-to-successor shed verdict — never a client-visible abort and
        never a locally minted proposal whose serve-state writes the fence
        would reject anyway."""
        if owner and owner in self._peers and owner in alive:
            resp = self._forward(owner, study_id, trial_id, trial_number, op_token)
            if resp is not None:
                return resp
        from optuna_tpu_torch.storages._grpc.suggest_service import RESOURCE_EXHAUSTED

        return {
            "params": {},
            "dists": {},
            "fallback": None,
            "shed": "reject",
            "status": RESOURCE_EXHAUSTED,
            "retry_after_s": 0.05,
            "redial_to": owner or None,
            "source": "lease",
        }

    def _forward(
        self,
        peer_name: str,
        study_id: int,
        trial_id: int,
        trial_number: int,
        op_token: str | None,
    ) -> dict | None:
        peer = self._peers.get(peer_name)
        if peer is None:
            return None
        flow = flight.new_flow_id() if flight.enabled() else None
        if flow is not None:
            flight.flow(
                FORWARD_FLOW, flow, "out",
                trial=trial_number, meta={"from": self.name, "to": peer_name},
            )
        telemetry.count(
            "serve.fleet.ask_forward",
            meta={"from": self.name, "to": peer_name, "trial": trial_number},
        )
        try:
            return peer.service_forwarded_ask(
                study_id, trial_id, trial_number,
                op_token=op_token, flow=flow, src=self.name,
            )
        except Exception as err:  # graphlint: ignore[PY001] -- a peer that dies mid-forward must degrade to a local answer (the forwarding hub IS a valid successor), never surface as a client-visible failure; a device fault is the exception
            if is_device_fault(err):
                # The owner's card or kernel failed: answered as the error,
                # never hidden behind this hub's answer.
                raise
            _logger.warning(
                f"forward to fleet hub {peer_name!r} raised {err!r}; answering locally."
            )
            return None

    # ------------------------------------------------------ fleet shedding

    def service_burn_verdict(self) -> dict:
        """This hub's SLO burn verdict for the fleet channel (peers rank
        forward targets by it)."""
        verdict = self.service.service_burn_verdict()
        verdict["hub"] = self.name
        return verdict

    @staticmethod
    def _burn_key(verdict: Mapping[str, Any]) -> tuple[float, float]:
        if verdict.get("draining"):
            return (float("inf"), float("inf"))
        score = float(verdict.get("score", 0.0))
        if verdict.get("critical"):
            score = float("inf")
        return (score, float(verdict.get("depth", 0)))

    def _least_burning_peer(self, alive: frozenset[str]) -> str | None:
        """The alive peer with the smallest (burn score, inflight depth) —
        the SLO burn verdicts, exchanged hub-to-hub, deciding where an
        overload burst spills before any client sees it."""
        best: tuple[tuple[float, float], str] | None = None
        for name in self.router.hubs:
            if name == self.name or name not in alive:
                continue
            peer = self._peers.get(name)
            if peer is None:
                continue
            try:
                verdict = peer.service_burn_verdict()
            except Exception as err:  # graphlint: ignore[PY001] -- an unreachable peer simply drops out of the candidate set; shedding decisions must never raise
                _logger.warning(f"burn verdict from hub {name!r} raised {err!r}.")
                continue
            key = self._burn_key(verdict)
            if key[0] == float("inf"):
                continue  # critical or draining: not a shed target
            if best is None or key < best[0]:
                best = (key, name)
        return best[1] if best is not None else None

    def _shed_forward(
        self,
        study_id: int,
        trial_id: int,
        trial_number: int,
        op_token: str | None,
        alive: frozenset[str],
    ) -> dict | None:
        """One rung before shedding to the client: forward the rejected ask
        to the least-burning peer. Returns the peer's answer unless the
        peer rejected too (a fleet-wide burst still walks the client
        ladder)."""
        peer_name = self._least_burning_peer(alive)
        if peer_name is None:
            return None
        telemetry.count(
            "serve.fleet.shed_forward",
            meta={"from": self.name, "to": peer_name, "trial": trial_number},
        )
        resp = self._forward(peer_name, study_id, trial_id, trial_number, op_token)
        if resp is None or resp.get("shed") == "reject":
            return None
        return resp

    # ------------------------------------------------------------ failover

    def _adopt(self, study_id: int, alive: frozenset[str]) -> None:
        """First local answer for a study: adopt the fleet's published
        ready-queue epoch watermark (so this hub's epochs continue, not
        restart) and count the re-homing when the primary owner is dead.
        The coalescer and ready queue themselves rebuild lazily from the
        shared journal — the service's handle creation already reads the
        full history every hub shares."""
        with self._adopt_lock:
            if study_id in self._adopted:
                return
            self._adopted.add(study_id)
        if self.solo:
            return
        floor = self.replicator.watermark_epoch(study_id)
        if floor > 0:
            handle = self.service._handle(study_id)
            while handle.queue.epoch < floor:
                handle.queue.invalidate()
        primary = self.router.hub_for(study_id)
        if primary != self.name and primary not in alive:
            telemetry.count(
                "serve.fleet.hub_rehome",
                meta={"study": study_id, "dead": primary, "to": self.name},
            )
            warm = self._warm_load(study_id)
            _logger.warning(
                f"study {study_id} re-homed from dead hub {primary!r} to "
                f"{self.name!r}; serve state rebuilt from the shared journal"
                + (" with the dead hub's fitted sampler state warm-loaded."
                   if warm else "; no warm fitted state was available.")
            )

    def _warm_load(self, study_id: int) -> bool:
        """Warm-load the dead primary's ``ckpt:hub`` checkpoint into this
        hub's handle: its fitted sampler state (so the successor's first
        fit is warm, not cold) and its ready-queue epoch watermark (a
        second floor beside the replicator's, for the window where the
        dead hub checkpointed past its last watermark publish). Best-effort
        trust-but-verify: a torn/stale blob just means a cold fit."""
        record = _ckpt.load_checkpoint(
            self.service._storage, study_id, "hub"
        )
        if record is None:
            return False
        handle = self.service._handle(study_id)
        with handle.lock:
            warmed = _ckpt.restore_sampler_state(
                handle.guarded, record.state.get("sampler")
            )
            epoch_floor = int(record.state.get("epoch", 0))
            while handle.queue.epoch < epoch_floor:
                handle.queue.invalidate()
        if warmed:
            telemetry.count(
                "checkpoint.warm_load",
                meta={"study": study_id, "to": self.name, "seq": record.seq},
            )
        return warmed

    def _publish_watermark(self, study_id: int) -> None:
        if self.solo:
            return
        handle = self.service._handles.get(study_id)
        if handle is None:
            return
        epoch = handle.queue.epoch
        if self._published_epochs.get(study_id) == epoch:
            return
        self._published_epochs[study_id] = epoch
        fence = self.leases.held_epoch(study_id) if self.leases is not None else 0
        self.replicator.record_watermark(
            study_id, self.name, epoch=epoch, asks=handle.asks_since_fill,
            fence=fence,
        )


# ---------------------------------------------------------------- client


class FleetClient:
    """Client-side fleet routing: ask the owner, redial the next ring
    replica on transport-unavailable under a
    :class:`~optuna_tpu_torch.storages._retry.RetryPolicy` (full-jitter backoff
    between redials). Redial attempts are marked ``fleet_redial`` so the
    successor checks the shared replay record before re-executing — the
    exactly-once contract across a hub death.

    ``asks`` maps hub name -> callable ``(study_id, trial_id, number,
    token, fleet_redial) -> dict`` (a bound gRPC call, or the in-process
    harness's rpc closure). The resulting :meth:`ask` is exactly the
    callable :class:`ThinClientSampler` takes.
    """

    def __init__(
        self,
        router: FleetRouter,
        asks: Mapping[str, Callable[..., dict]],
        *,
        retry_policy: RetryPolicy | None = None,
        is_unavailable: Callable[[BaseException], bool] | None = None,
    ) -> None:
        missing = [hub for hub in router.hubs if hub not in asks]
        if missing:
            raise ValueError(f"no ask callable for fleet hubs {missing!r}.")
        self.router = router
        self._asks = dict(asks)
        self._retry = (
            retry_policy
            if retry_policy is not None
            else RetryPolicy(
                max_attempts=2 * len(router.hubs) + 1,
                initial_backoff=0.05,
                max_backoff=1.0,
                deadline=30.0,
            )
        )
        self._is_unavailable = (
            is_unavailable if is_unavailable is not None else _default_unavailable
        )

    def ask(self, study_id: int, trial_id: int, number: int, token: str) -> dict:
        order = self.router.successors(study_id)
        attempt = 0
        redial_to: str | None = None
        while True:
            hub = (
                redial_to
                if redial_to is not None and redial_to in self._asks
                else order[attempt % len(order)]
            )
            redial_to = None
            try:
                resp = self._asks[hub](
                    study_id, trial_id, number, token, attempt > 0
                )
            except Exception as err:  # graphlint: ignore[PY001] -- the injected classifier decides retryability; everything else re-raises to the sampler's degradation boundary
                attempt += 1
                if not self._is_unavailable(err) or attempt >= self._retry.max_attempts:
                    raise
                _logger.warning(
                    f"fleet hub {hub!r} unavailable ({type(err).__name__}); "
                    f"redialing next replica (attempt {attempt})."
                )
                # Same token on the redial: the successor dedupes through
                # the shared replay record, so a committed-but-unacked ask
                # is answered, not re-executed.
                self._retry.backoff(attempt)
                continue
            if (
                isinstance(resp, Mapping)
                and resp.get("source") == "lease"
                and resp.get("shed") == "reject"
                and attempt + 1 < self._retry.max_attempts
            ):
                # A demoted (fence-tripped) hub drained us toward the lease
                # owner: redial there with the same token — the owner either
                # answers fresh or replays the shared record. Never an
                # abort; a fleet that cannot name a live owner just walks
                # the ring like any unavailable-hub redial.
                attempt += 1
                target = resp.get("redial_to")
                redial_to = target if isinstance(target, str) else None
                _logger.warning(
                    f"fleet hub {hub!r} is demoted for study {study_id}; "
                    f"redialing"
                    + (f" lease owner {redial_to!r}" if redial_to else " next replica")
                    + f" (attempt {attempt})."
                )
                self._retry.backoff(attempt)
                continue
            return resp


def _default_unavailable(err: BaseException) -> bool:
    if isinstance(err, (HubUnavailableError, ConnectionError, TimeoutError)):
        return True
    from optuna_tpu_torch.storages._grpc.client import is_transport_unavailable

    return is_transport_unavailable(err)


# ------------------------------------------------------- socket plumbing


class _RemotePeer:
    """Peer protocol over a real socket: lazily dials the peer hub's gRPC
    endpoint (``host:port`` — its fleet name) and issues the forwarded-ask /
    burn-verdict suggest RPCs."""

    def __init__(self, endpoint: str) -> None:
        self.endpoint = endpoint
        self._proxy: Any | None = None
        self._lock = locksan.lock("fleet.peer")

    def _ensure(self) -> Any:
        with self._lock:
            if self._proxy is None:
                from optuna_tpu_torch.storages._grpc.client import GrpcStorageProxy

                host, _, port = self.endpoint.rpartition(":")
                self._proxy = GrpcStorageProxy(
                    host=host or "localhost",
                    port=int(port),
                    retry_policy=RetryPolicy(max_attempts=1),
                )
            return self._proxy

    def service_forwarded_ask(self, *args: Any, **kwargs: Any) -> dict:
        return self._ensure()._call("service_forwarded_ask", *args, **kwargs)

    def service_burn_verdict(self) -> dict:
        return self._ensure()._call("service_burn_verdict")


def remote_peers(hubs: Sequence[str], self_name: str) -> dict[str, _RemotePeer]:
    """Socket peers for every *other* hub in an endpoint-named fleet."""
    return {hub: _RemotePeer(hub) for hub in hubs if hub != self_name}


def fleet_asks(hubs: Sequence[str]) -> dict[str, Callable[..., dict]]:
    """Client-side ``service_ask`` callables over real sockets, one per
    endpoint-named hub — exactly the ``asks`` mapping :class:`FleetClient`
    wants. Each dials lazily with ``max_attempts=1`` (the FLEET's retry
    policy walks the ring; per-hub transport retries underneath it would
    multiply the failover latency) and forwards the fleet client's token
    verbatim, so a redial to a different hub replays as the same op."""
    from optuna_tpu_torch.storages._grpc._service import OP_TOKEN_KEY

    def make(endpoint: str) -> Callable[..., dict]:
        peer = _RemotePeer(endpoint)

        def ask(
            study_id: int,
            trial_id: int,
            number: int,
            token: str,
            fleet_redial: bool,
        ) -> dict:
            return peer._ensure()._call(
                "service_ask",
                study_id,
                trial_id,
                number,
                fleet_redial=fleet_redial,
                **{OP_TOKEN_KEY: token},
            )

        return ask

    return {hub: make(hub) for hub in hubs}


def attach_hub(
    service: "SuggestService",
    storage: "BaseStorage",
    hubs: Sequence[str],
    name: str,
    *,
    replicas: int = 64,
    lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
    lease_check_ttl_s: float = 1.0,
) -> FleetHub:
    """Wrap ``service`` as fleet member ``name`` of an endpoint-named fleet
    (``run_grpc_proxy_server(..., fleet_hubs=..., fleet_name=...)`` calls
    this): the returned hub is the ``suggest_service`` the server mounts."""
    router = FleetRouter(hubs, replicas=replicas)
    return FleetHub(
        name, service, router, storage,
        peers=remote_peers(router.hubs, name),
        lease_ttl_s=lease_ttl_s,
        lease_check_ttl_s=lease_check_ttl_s,
    )
