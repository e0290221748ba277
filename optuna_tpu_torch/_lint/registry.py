"""Canonical machine-checked invariants shared by graphlint rules (PyTorch port).

This module is the port's single source of truth for facts that used to
live only in reviewers' heads. Every vocabulary is a literal copy of the
JAX package's (``tests/test_torch_lint.py`` holds the two equal); every
target path names the port's module of the same role:

* :data:`REPLAY_UNSAFE_REGISTRY` — the storage write methods whose blind
  replay after a committed-but-unacked first attempt is observably wrong.
  Three code sites carry a hand-written copy of this set, each for a
  different reason (see :data:`STO001_TARGETS`); rule **STO001** fails the
  lint if any copy drifts from this registry.
* :data:`NON_FINITE_POLICY_REGISTRY` — the batch executor's non-finite
  quarantine policies; rule **EXE001** keeps the executor's literal set and
  the fault-injection chaos matrix in sync (see :data:`EXE001_TARGETS`).
* :data:`FALLBACK_POLICY_REGISTRY` — the sampler resilience layer's
  fallback policies; rule **SMP001** keeps the ``GuardedSampler`` literal
  set and the fault-injection chaos matrix in sync (see
  :data:`SMP001_TARGETS`). :data:`SMP002_CHOLESKY_HELPER` names the single
  blessed Cholesky call site for sampler code (rule **SMP002**).
* :data:`TELEMETRY_PHASE_REGISTRY` / :data:`TELEMETRY_COUNTER_REGISTRY` —
  the observability vocabulary (span/phase names shared by profiler
  annotations and metrics histograms; containment-counter families).
* :data:`DEVICE_MODULE_PATHS` — the f32-hardened modules where **TPU003**
  applies. :data:`DEVICE_PROGRAMS` — the functions whose bodies run on the
  card with no host read by design: the scope of **TPU001** and
  **OBS001**, which in an eager package cannot come from ``jit``.
* :data:`HOST_BOUNDARY_F64` — the reviewed host-side functions inside
  device modules that legitimately touch float64 (rule **TPU003** skips
  them). Every entry documents why that boundary is host-only.
* :data:`NOT_APPLICABLE_RULES` — the JAX package's rules with no eager
  counterpart, each with its reason; ``all_rules()`` does not run them.

Keep this file boring: plain literals only, so the rules can cross-check
other files against it without importing anything heavy.
"""

from __future__ import annotations

#: Storage writes that must never be blindly replayed: a second create mints
#: a duplicate trial/study, a replayed WAITING->RUNNING claim CAS loses to
#: its own winner, a replayed param/terminal-state write raises against the
#: now-claimed trial, a replayed delete raises KeyError. Values say *why*
#: each method is replay-unsafe — the reasons surface in STO001 messages.
REPLAY_UNSAFE_REGISTRY: dict[str, str] = {
    "create_new_study": "replay raises DuplicatedStudyError or mints a second auto-named study",
    "delete_study": "replay raises KeyError against the already-deleted study",
    "create_new_trial": "replay mints a duplicate trial",
    "create_new_trials": "replay mints a duplicate batch of trials",
    "set_trial_param": "replay raises against the now-claimed/finished trial",
    "set_trial_state_values": "replayed claim CAS reports a lost race to its own winner",
}

#: The three hand-maintained copies STO001 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
STO001_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/storages/_retry.py",
        "REPLAY_UNSAFE_METHODS",
        "RetryingStorage's pass-through set (these calls are not retried)",
    ),
    (
        "optuna_tpu_torch/storages/_grpc/client.py",
        "_OP_TOKEN_METHODS",
        "wire-protocol constant: RPCs that carry a dedupe op token",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "REPLAY_UNSAFE_CHAOS_MATRIX",
        "chaos matrix: every replay-unsafe write must have an injection scenario",
    ),
)

#: The non-finite quarantine policies the vectorized batch executor
#: accepts, with the containment semantics each one promises. Two code
#: sites carry a hand-written copy (see :data:`EXE001_TARGETS`); rule
#: **EXE001** fails the lint if either drifts from this registry.
NON_FINITE_POLICY_REGISTRY: dict[str, str] = {
    "fail": "quarantine: non-finite trials are told FAIL; the rest of the batch completes",
    "raise": "strict: quarantine as FAIL first, then raise to the caller",
    "clip": "degrade: nan_to_num in-graph; every trial completes with finite values",
}

#: The hand-maintained copies EXE001 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
EXE001_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/parallel/executor.py",
        "NON_FINITE_POLICIES",
        "the executor's accepted policy literals (validated at construction)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "NON_FINITE_CHAOS_POLICIES",
        "chaos matrix: every quarantine policy must have an injection scenario",
    ),
)

#: The sampler fallback policies the resilience layer accepts, with the
#: containment semantics each one promises. Two code sites carry a
#: hand-written copy (see :data:`SMP001_TARGETS`); rule **SMP001** fails the
#: lint if either drifts from this registry.
FALLBACK_POLICY_REGISTRY: dict[str, str] = {
    "independent": "degrade: a sampler failure falls back to independent/random sampling",
    "raise": "strict: record the fallback attr, then re-raise the sampler's error",
}

#: The hand-maintained copies SMP001 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
SMP001_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/samplers/_resilience.py",
        "FALLBACK_POLICIES",
        "the resilience layer's accepted policy literals (validated at construction)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "FALLBACK_CHAOS_POLICIES",
        "chaos matrix: every fallback policy must have an injection scenario",
    ),
)

#: The telemetry phase vocabulary (one name set for profiler annotations AND
#: metrics histograms): canonical mirror of ``telemetry.py::PHASES``.
#: ``tests/test_torch_observability.py`` fails if the two drift — a phase added to the
#: instrumentation without joining the documented vocabulary is a test
#: failure, the STO001 discipline applied to observability names.
TELEMETRY_PHASE_REGISTRY: dict[str, str] = {
    "ask": "trial creation + parameter suggestion (Study.ask / ask_batch)",
    "ask.search_space": "relative search-space construction inside the sampler",
    "ask.fit": "surrogate fit inputs + fitting (host packing, GP/TPE fit)",
    "ask.propose": "acquisition optimization / fused proposal dispatch",
    "dispatch": "objective execution (serial call or batched device dispatch)",
    "tell": "result commit + callbacks (study.tell / batch tell loop)",
    "storage.op": "one logical storage operation (retries + backoff included)",
    "scan.chunk": "one device-resident scan chunk: fit, factorization and its ask/evaluate/tell steps",
    "scan.sync": "chunk-boundary result read-back + storage sync of a scan chunk's trials",
    "shard.exchange": "one pod-wide ICI-journal exchange point at a sharded batch boundary",
    "serve.ask": "one suggestion-service ask served end to end (queue pop, shed rung, or coalesced dispatch)",
    "serve.coalesce": "one fused proposal dispatch answering a whole coalesced ask batch",
    "serve.ready_queue": "one speculative ask-ahead refill dispatch (background, off the RPC path)",
    "ckpt.write": "one best-effort durable checkpoint write at a loop boundary (encode + attr write)",
    "ckpt.restore": "one resume's checkpoint validation + carry reconstruction (load, verify, rebuild)",
    "ask.create": "the batch's trial creation (Study.ask_batch) inside the batch executor's ask",
    "ask.suggest": "the batch executor's per-trial suggestion loop: each trial's parameters written, its dispatch tagged",
    "dispatch.wait": "the host blocked in a dispatch's one read of its results (.cpu()), waiting for the card",
}

#: The containment-counter families: canonical mirror of
#: ``telemetry.py::COUNTERS`` (same drift test). Every family must have a
#: chaos scenario in ``tests/test_telemetry_chaos.py``.
TELEMETRY_COUNTER_REGISTRY: dict[str, str] = {
    "storage.retry": "RetryPolicy replayed a transiently-failed call",
    "grpc.redial": "gRPC client dropped a wedged channel and dialed fresh",
    "grpc.op_token_dedup": "gRPC server deduped a replayed replay-unsafe write",
    "sampler.fallback": "(suffixed by phase) a suggestion degraded to the independent path",
    "executor.quarantine": "a non-finite trial was quarantined as FAIL",
    "executor.bisection": "a failed dispatch was bisected to isolate poison trials",
    "executor.oom_halving": "an OOM-shaped dispatch error halved the batch",
    "executor.dispatch_timeout": "a device dispatch overran its deadline and was abandoned",
    "heartbeat.reap": "a stale (dead-worker) RUNNING trial was reaped to FAIL",
    "journal.lock_contention": "a journal lock acquire found the lock held and backed off",
    "serve.shed": "(suffixed by policy) an overloaded ask was degraded or refused by the shed ladder",
    "serve.ready_queue": "(suffixed hit|miss|refill|invalidate) a speculative ready-queue event on the suggestion service",
    "autopilot.action": "(suffixed by action id, or 'rollback'/'held') the autopilot decided a guarded remediation (observe logs it, act executes it)",
    "serve.fleet": "(suffixed by fleet event) a hub-fleet routing decision: forward, replay, re-home, or a declared hub death",
    "fleet.lease": "(suffixed by lease event) a study-ownership lease transition: acquire, renew, takeover, or a fence-tripped hub's self-demotion",
    "fleet.fenced_write": "a stale-epoch serve-state write from a zombie hub was rejected by the lease fence (StaleLeaseError)",
    "grpc.op_token_evicted_live": "an op-token dedupe entry younger than the client retry window was evicted (server LRU or fleet replay ring): a delayed duplicate would re-execute",
    "locksan.verdict": "(suffixed by kind) the lock sanitizer reported a potential deadlock cycle or a blocking window under held locks",
    "checkpoint": "(suffixed by checkpoint event) a durable-checkpoint lifecycle event: write, rejection, restore, fallback, or warm load",
    "journal.snapshot_rejected": "a journal snapshot failed its CRC/unpickle validation and was replaced by a full log replay",
}

#: The flight recorder's event-kind vocabulary: canonical mirror of
#: ``flight.py::EVENT_KINDS`` (rule **OBS002**, the STO001 machinery pointed
#: at observability). Span *names* within the ``phase`` kind come from
#: :data:`TELEMETRY_PHASE_REGISTRY` and ``containment`` names from
#: :data:`TELEMETRY_COUNTER_REGISTRY`, so the kinds are the only new
#: vocabulary the recorder introduces. Every kind must have an acceptance
#: scenario in ``testing/fault_injection.py::FLIGHT_EVENT_CHAOS_MATRIX``
#: (cross-checked by the same rule).
FLIGHT_EVENT_REGISTRY: dict[str, str] = {
    "phase": "a timed study-loop phase span (names: the telemetry phase vocabulary)",
    "trial": "a trial lifecycle instant (ask'd / told) carrying the trial number",
    "containment": "a containment event (names: the telemetry counter families)",
    "rpc.client": "a gRPC client op span carrying this worker's trace/span ids",
    "rpc.server": "a gRPC server handler span tagged with the calling client's span",
    "jit.compile": "a jit wrapper's executable cache grew: a compile, with call seconds",
    "jit.retrace": "a jit wrapper's cache grew after its first entry (runtime TPU002)",
    "gauge": "a sampled runtime device gauge (HBM high-water, cache sizes)",
    "postmortem": "the recorder tail was flushed to a bounded JSON dump",
    "flow": "a causal flow-edge endpoint (fan-in to a coalesced dispatch / fan-out from a refill), rendered as a Perfetto flow arrow",
}

#: The hand-maintained copies OBS002 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
OBS002_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/flight.py",
        "EVENT_KINDS",
        "the recorder's accepted event kinds (validated on every record)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "FLIGHT_EVENT_CHAOS_MATRIX",
        "chaos matrix: every event kind must have an acceptance scenario",
    ),
)

#: The device-stat vocabulary: the in-graph counters jitted programs return
#: as a fixed-shape auxiliary stats struct (i32/f32 scalars — no shape
#: polymorphism, no extra dispatches) and ``device_stats.harvest()``
#: publishes at the host boundary. Canonical mirror of
#: ``device_stats.py::DEVICE_STATS`` (rule **OBS003**, the STO001 machinery
#: pointed at on-device observability). Values say what each stat reports;
#: every stat must have an injection scenario in ``testing/
#: fault_injection.py::DEVICE_STAT_CHAOS_MATRIX`` (same rule).
DEVICE_STAT_REGISTRY: dict[str, str] = {
    "gp.ladder_rung": "jitter-ladder escalations the Cholesky needed (0 = bare factor was finite)",
    "gp.fit_iterations": "L-BFGS iterations the fused kernel-param fit actually ran",
    "gp.proposal_fallback_coords": "proposal coordinates that took the per-coordinate isfinite fallback",
    "gp.best_acq": "best acquisition value the fused proposal search found",
    "gp.inducing_count": "live inducing points backing the sparse (SGPR) posterior (absent below the exact-size threshold)",
    "gp.sparsity_ratio": "inducing count over real history size for the last sparse fit (m/n; 1.0 would mean no compression)",
    "gp.inducing_swaps": "inducing-set swap-ins the scan loop performed (each is one O(nm^2) SGPR rebuild; a warmed-up set stops swapping)",
    "gp.sparse_heldout_err": "mean |predicted - observed| standardized-score error of the last sparse scan chunk, measured before ingestion (a one-step-ahead held-out residual)",
    "executor.quarantined": "trials quarantined as FAIL in one batch dispatch, from the in-graph isfinite mask (0 under non_finite='clip': nothing is quarantined)",
    "scan.rank1_updates": "scan-loop tells that took the O(n^2) incremental Cholesky row append",
    "scan.refactorizations": "scan-loop tells whose pivot check fell back to a full jitter-ladder refactorization",
    "scan.quarantined": "non-finite objective slots quarantined in-graph inside a scan chunk (told FAIL at sync, never ingested)",
    "scan.chunk_fill": "real (ingested) trials the last scan chunk added to the HBM history",
    "shard.width": "per-shard slot rows of the last sharded dispatch (batch padded to a trials-shard multiple)",
    "shard.quarantined": "trials quarantined as FAIL across one sharded dispatch, from the in-graph isfinite mask",
    "shard.contained_groups": "shard groups re-dispatched in isolation after a failed sharded dispatch (per-shard containment)",
}

#: The hand-maintained copies OBS003 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
OBS003_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/device_stats.py",
        "DEVICE_STATS",
        "the harvest harness's accepted stat names (validated on every harvest)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "DEVICE_STAT_CHAOS_MATRIX",
        "chaos matrix: every device stat must have an injection scenario",
    ),
)

#: The study doctor's check-id vocabulary: every diagnostic finding
#: ``optuna_tpu_torch/health.py`` can emit carries one of these ids. Canonical
#: mirror of ``health.py::HEALTH_CHECKS`` (rule **OBS004**, the STO001
#: machinery pointed at fleet diagnostics). Values say what each check
#: detects; every check must have a fault scenario in ``testing/
#: fault_injection.py::HEALTH_CHECK_CHAOS_MATRIX`` (same rule) — a doctor
#: check nobody has proven fires is worse than no check: it certifies sick
#: studies healthy.
HEALTH_CHECK_REGISTRY: dict[str, str] = {
    "study.stagnation": "no new best value over the trailing window of completed tells",
    "sampler.fallback_storm": "the configured sampler is degrading to the independent path at storm rate",
    "sampler.duplicate_proposals": "completed trials repeat earlier parameter points at high rate",
    "executor.quarantine_rate": "non-finite quarantines + heartbeat reaps are consuming the budget",
    "executor.dispatch_timeouts": "repeated dispatch-deadline strikes (each abandons a watchdog thread)",
    "jit.retrace_churn": "jit wrappers keep retracing after their first compile (runtime TPU002)",
    "gp.ladder_escalation": "the Cholesky jitter ladder is escalating rungs on real fits",
    "gp.sparse_degraded": "the sparse GP's one-step-ahead held-out error says the inducing set no longer covers the search",
    "worker.dead": "a worker's health snapshot went stale past its report interval",
    "shard.imbalance": "one trial shard's throughput fell >= 2x below the mesh median",
    "service.backpressure": "the suggestion service is shedding asks (overload ladder engaged)",
    "service.ready_queue_starved": "steady-state asks keep missing the speculative ready queue",
    "service.slo_burn": "an SLO is burning its error budget (severity escalates with the burn rate)",
    "service.hub_dead": "a suggestion hub's -serve snapshot went stale: the fleet re-homes its studies to ring successors",
    "service.hub_flapping": "a study's lease bounced between hubs repeatedly inside a window (asymmetric partition / liveness disagreement)",
    "service.hub_zombie_fenced": "a declared-dead hub is still writing: the lease fence is rejecting its stale-epoch serve-state writes",
    "service.partition_suspected": "a study's lease was taken over while the deposed hub still publishes live snapshots: partition, not crash",
    "checkpoint.stale": "resume is rejecting checkpoint blobs (torn, corrupt, or watermark-stale): restores are paying full recomputes",
}

#: The hand-maintained copies OBS004 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
OBS004_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/health.py",
        "HEALTH_CHECKS",
        "the doctor's accepted check ids (validated on every finding)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "HEALTH_CHECK_CHAOS_MATRIX",
        "chaos matrix: every health check must have a fault scenario that fires it",
    ),
)

#: The suggestion service's load-shedding ladder (the overload rungs
#: ``storages/_grpc/suggest_service.py`` may answer an ask with), mildest
#: first. Two code sites carry a hand-written copy (see
#: :data:`SRV001_TARGETS`); rule **SRV001** fails the lint if either drifts
#: from this registry — a shed rung nobody has chaos-tested is a silent way
#: to drop asks under exactly the load that makes debugging hardest.
SHED_POLICY_REGISTRY: dict[str, str] = {
    "stale_queue": "degrade: serve a stale (posterior-moved) ready-queue proposal without a fit",
    "independent": "degrade: serve an empty relative proposal; the client samples independently",
    "reject": "backpressure: refuse the ask with RESOURCE_EXHAUSTED and a retry-after hint",
}

#: The hand-maintained copies SRV001 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
SRV001_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/storages/_grpc/suggest_service.py",
        "SHED_POLICIES",
        "the service's accepted shed rungs (the ladder decide() can answer with)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "SHED_CHAOS_POLICIES",
        "chaos matrix: every shed rung must have an overload scenario that forces it",
    ),
)

#: The SLO id vocabulary: every objective the SLO engine can evaluate
#: (``optuna_tpu_torch/slo.py``) — and every ``service.slo_burn`` finding, shed
#: decision, and ``optuna_tpu_slo_*`` gauge derived from one — carries one
#: of these ids. Canonical mirror of ``slo.py::SLO_SPECS`` (rule **OBS005**,
#: the STO001 machinery pointed at the objectives themselves). Values
#: describe the shipped parameterization; every id must have a burn
#: scenario in ``testing/fault_injection.py::SLO_CHAOS_MATRIX`` (same rule)
#: — an objective nobody has proven can burn certifies a violated promise
#: as kept.
SLO_REGISTRY: dict[str, str] = {
    "serve.ask.latency": "serve.ask p99 <= 5ms over 1h at 99% (the suggestion service's per-ask contract)",
    "storage.op.latency": "storage.op p99 <= 50ms over 1h at 99.9% (one logical storage op incl. retries)",
    "dispatch.latency": "dispatch p99 <= 30s over 1h at 99% (one objective dispatch, serial or batched)",
    "tell.latency": "tell p99 <= 100ms over 1h at 99.9% (result commit + callbacks)",
    "scan.chunk.latency": "scan.chunk p99 <= 10s over 1h at 99% (one HBM-resident scan-chunk dispatch)",
}

#: The hand-maintained copies OBS005 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
OBS005_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/slo.py",
        "SLO_SPECS",
        "the engine's declared objectives (validated at spec construction)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "SLO_CHAOS_MATRIX",
        "chaos matrix: every SLO must have a burn scenario that trips it",
    ),
)

#: The autopilot's guarded-action vocabulary: every remediation the
#: doctor-driven control loop (``optuna_tpu_torch/autopilot.py``) can decide —
#: and every ``autopilot.action.*`` counter, flight event, and
#: ``autopilot:action:*`` study attr derived from one — carries one of
#: these ids. Canonical mirror of ``autopilot.ACTIONS`` (rule **ACT001**,
#: the STO001 machinery pointed at the actuators themselves). Values say
#: which doctor finding triggers the action and what knob it turns; every
#: id must have a chaos scenario in ``testing/fault_injection.py::
#: AUTOPILOT_CHAOS_MATRIX`` (same rule) — an action nobody has proven
#: fires, executes, and rolls back is a remediation that may fire for the
#: first time in production, unattended.
AUTOPILOT_ACTION_REGISTRY: dict[str, str] = {
    "sampler.restart": "study.stagnation -> reseed + a bounded independent exploration burst via GuardedSampler",
    "sampler.pin_independent": "sampler.fallback_storm -> pre-emptively pin the independent path for N trials (skip the failing fit)",
    "executor.pin_shapes": "jit.retrace_churn -> freeze the executor's batch width at the dominant compiled width",
    "executor.tighten_regrowth": "executor.quarantine_rate -> stretch the executor's probationary batch-regrowth streak",
    "service.shed_earlier": "service.slo_burn/service.backpressure -> halve the shed thresholds and widen ready-queue prewarm",
    "gp.densify": "gp.sparse_degraded -> widen the sparse GP engine: double the inducing capacity, or fall back to the exact posterior once at cap",
}

#: The hand-maintained copies ACT001 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
ACT001_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/autopilot.py",
        "ACTIONS",
        "the control loop's accepted action ids (validated on every decision)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "AUTOPILOT_CHAOS_MATRIX",
        "chaos matrix: every guarded action must have a fault scenario that forces it",
    ),
)

#: The hub fleet's routing-event vocabulary: every fault-tolerance decision
#: the fleet layer (``storages/_grpc/fleet.py``) can take — and every
#: ``serve.fleet.*`` counter and cross-hub flow arrow derived from one —
#: carries one of these ids. Canonical mirror of ``fleet.FLEET_EVENTS``
#: (rule **FLT001**, the STO001 machinery pointed at failover itself).
#: Values say what each event means for an in-flight ask; every id must
#: have a chaos scenario in ``testing/fault_injection.py::
#: HUB_CHAOS_MATRIX`` (same rule) — a failover path nobody has killed a hub
#: through is a path that loses its first real ask in production.
FLEET_EVENT_REGISTRY: dict[str, str] = {
    "hub_dead": "a hub's -serve health snapshot went stale past grace: the router stops routing to it",
    "hub_rehome": "a dead hub's study was adopted by its ring successor, which rebuilds serve state from the shared journal",
    "ask_forward": "an ask was forwarded to a peer hub (mis-route to the owner, or overload to the least-burning peer)",
    "ask_replayed": "a redialed ask was answered from the shared replay record instead of re-executing (exactly-once across failover)",
    "shed_forward": "an overloaded hub forwarded an ask to the least-burning peer one rung before shedding to the client",
}

#: The hand-maintained copies FLT001 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
FLT001_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/storages/_grpc/fleet.py",
        "FLEET_EVENTS",
        "the fleet layer's accepted routing events (each counted as serve.fleet.<event>)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "HUB_CHAOS_MATRIX",
        "chaos matrix: every fleet event must have a hub-fault scenario that forces it",
    ),
)

#: The lease/fence event vocabulary: every study-ownership transition the
#: lease layer (``storages/_grpc/fleet.py::StudyLeases`` + the
#: ``LeaseFencedStorage`` write fence) can take — and every
#: ``fleet.lease.*`` counter plus the standalone ``fleet.fenced_write``
#: derived from one — carries one of these ids. Canonical mirror of
#: ``fleet.LEASE_EVENTS`` (rule **FLT002**, the STO001 machinery pointed at
#: split-brain protection itself). Values say what each transition means
#: for the study's write fence; every id must have a gray-failure scenario
#: in ``testing/fault_injection.py::LEASE_CHAOS_MATRIX`` (same rule) — a
#: fence nobody has run a zombie hub into is a fence that admits its first
#: double-applied write in production.
LEASE_EVENT_REGISTRY: dict[str, str] = {
    "acquire": "a hub claimed an unleased study: epoch 1, the fence baseline every later takeover bumps past",
    "renew": "the lease owner re-asserted its claim at the adaptive renewal cadence (read-check-then-write, injectable clock)",
    "takeover": "a successor (re-home) or the returning ring primary (failback) bumped the epoch and displaced the recorded owner",
    "demote": "a hub observed its claim was stale (fence trip or renewal check) and stopped writing serve state for the study",
    "fenced_write": "a stale-epoch serve-state write was rejected by the lease fence with a typed StaleLeaseError",
}

#: The hand-maintained copies FLT002 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
FLT002_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/storages/_grpc/fleet.py",
        "LEASE_EVENTS",
        "the lease layer's accepted ownership transitions (counted as fleet.lease.<event> / fleet.fenced_write)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "LEASE_CHAOS_MATRIX",
        "chaos matrix: every lease event must have a gray-failure scenario that forces it",
    ),
)

#: The durable-checkpoint event vocabulary: every lifecycle event the
#: preemption-safe checkpoint layer (``optuna_tpu_torch/checkpoint.py``) can take
#: on a blob — and every ``checkpoint.*`` counter and doctor evidence field
#: derived from one — carries one of these ids. Canonical mirror of
#: ``checkpoint.CHECKPOINT_EVENTS`` (rule **CKPT001**, the STO001 machinery
#: pointed at crash recovery itself). Values say what each event means for
#: a preempted study; every id must have a preemption scenario in
#: ``testing/fault_injection.py::CHECKPOINT_CHAOS_MATRIX`` (same rule) — a
#: restore path nobody has SIGKILLed a loop through is a path that loses
#: its first real study to the fleet's *default* failure mode.
CHECKPOINT_EVENT_REGISTRY: dict[str, str] = {
    "write": "a loop boundary persisted a CRC-framed state blob into the ckpt: ring",
    "write_error": "a best-effort checkpoint write failed; the loop continued without it",
    "restore": "a resume rebuilt loop state from the newest valid blob",
    "rejected": "a blob failed CRC / schema-version / decode validation and was skipped",
    "stale": "a blob's trial-count watermark trailed the synced history and was skipped",
    "fallback": "no valid blob survived validation; state was recomputed from COMPLETE history",
    "warm_load": "a re-homing hub successor restored the dead hub's fitted sampler state",
}

#: The hand-maintained copies CKPT001 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
CKPT001_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/checkpoint.py",
        "CHECKPOINT_EVENTS",
        "the checkpoint layer's accepted lifecycle events (each counted as checkpoint.<event>)",
    ),
    (
        "optuna_tpu_torch/testing/fault_injection.py",
        "CHECKPOINT_CHAOS_MATRIX",
        "chaos matrix: every checkpoint event must have a preemption scenario that forces it",
    ),
)

#: The runtime lock sanitizer's named-lock vocabulary: every lock
#: ``optuna_tpu_torch/locksan.py`` wraps (opt-in via ``OPTUNA_TPU_TORCH_LOCKSAN=1``)
#: carries one of these names — the same name the sanitizer's verdicts,
#: ``locksan.verdict.*`` counters, and flight postmortems report. Canonical
#: mirror of ``locksan.py::LOCK_NAMES`` (rule **CONC004**, the STO001
#: machinery pointed at lock identity itself). Values say what each lock
#: guards; a lock wired into the sanitizer under a name this registry does
#: not list is a lint failure — an anonymous lock produces verdicts nobody
#: can map back to a code site.
LOCKSAN_REGISTRY: dict[str, str] = {
    "suggest.shed": "ShedPolicy's overload counters + rung state (decide() is the serve hot path)",
    "suggest.coalesce": "the ask coalescer's leader/follower window (a Condition: followers wait on it)",
    "suggest.ready_queue": "one study's speculative ready queue (epoch + proposals)",
    "suggest.handle": "one study's serve handle: serializes sampler dispatch vs refill vs prewarm",
    "suggest.handles": "the service's study-id -> handle map",
    "suggest.inflight": "the service's in-flight ask accounting (overload signal)",
    "suggest.refill": "the demand-refill wakeup (a Condition: the refill worker waits on it)",
    "suggest.thin_client": "the thin client sampler's per-trial proposal cache",
    "server.op_token": "the gRPC server's op-token replay cache + in-flight coalescing map",
    "fleet.liveness": "a fleet hub's liveness-TTL cache of dead hub ids",
    "fleet.adopt": "a fleet hub's adopted-studies set (re-home decisions)",
    "fleet.lease": "a hub's study-lease tables: held epochs, renewal deadlines, fence cache",
    "fleet.peer": "a remote peer stub's in-flight forward bookkeeping",
    "telemetry.registry": "the metrics registry's counter/gauge/histogram maps",
    "flight.jit_totals": "the flight recorder's per-label jit compile totals",
    "autopilot.step": "the autopilot's step serialization (reentrant: maybe_step -> step; report() shares it)",
    "health.doctor": "a health reporter's publish sequencing + gap bookkeeping",
    "slo.engine": "the SLO engine's quantile sketches + burn windows",
}

#: The hand-maintained copies CONC004 cross-checks, as
#: ``(path suffix, module-level symbol, why this site keeps its own copy)``.
#: Each symbol must statically evaluate to exactly the registry's key set.
#: CONC004 additionally flags any ``locksan.lock/rlock/condition("name")``
#: call site whose name literal is not a registry member.
CONC004_TARGETS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/locksan.py",
        "LOCK_NAMES",
        "the sanitizer's accepted lock names (validated at wrap time)",
    ),
)

#: The server/hot-path modules where rule **CONC002** forbids blocking calls
#: (storage ops, RPC dispatch, sleeps, joins, future waits, foreign-condition
#: waits) inside a ``with <lock>:`` body — the p99 regression class of the
#: suggestion service ("refresh runs OUTSIDE the policy lock"), promoted
#: from a review note to a lint. A trailing slash means "the whole subtree".
CONC002_HOT_PATHS: tuple[str, ...] = (
    "optuna_tpu_torch/storages/_grpc/",
    "optuna_tpu_torch/telemetry.py",
    "optuna_tpu_torch/flight.py",
    "optuna_tpu_torch/autopilot.py",
    "optuna_tpu_torch/health.py",
    "optuna_tpu_torch/slo.py",
)

#: The registered background-thread entrypoints for rule **CONC003**, as
#: ``(path suffix, Class.method, why that method runs on its own thread)``.
#: Any ``self.<attr>`` the entrypoint (or a method it calls one level deep)
#: assigns is thread-shared; a lock-free assignment to the same attr in any
#: other method of the class (``__init__`` excepted — construction
#: happens-before the thread starts) is a data race under the right
#: interleaving and is flagged at the main-path write site.
CONC003_THREAD_ENTRYPOINTS: tuple[tuple[str, str, str], ...] = (
    (
        "optuna_tpu_torch/storages/_heartbeat.py",
        "HeartbeatThread._record_periodically",
        "the per-batch liveness beat loop (daemon thread started by __enter__)",
    ),
    (
        "optuna_tpu_torch/storages/_grpc/suggest_service.py",
        "SuggestService._refill_loop",
        "the demand-scheduled ready-queue refill worker (daemon thread)",
    ),
)

#: The single blessed Cholesky call site for sampler code (rule **SMP002**):
#: every kernel solve in ``optuna_tpu_torch/samplers/`` must go through the
#: jitter-ladder helper there, which escalates diagonal jitter until the
#: factor is finite — a bare ``torch.linalg.cholesky`` raises on an
#: ill-conditioned Gram matrix and a bare ``cholesky_ex`` hands back a
#: partial factor with a nonzero ``info`` that nobody reads.
SMP002_SAMPLER_PATHS: tuple[str, ...] = ("optuna_tpu_torch/samplers/",)
SMP002_CHOLESKY_HELPER: str = "optuna_tpu_torch/samplers/_resilience.py"

#: Path fragments (posix, package-qualified) classifying a module as a
#: device module: f32-hardened, numerics on the card. A trailing slash
#: means "the whole subtree". ``ops/kernels/`` holds the hand-written CUDA
#: kernels' wrappers, in place of the JAX package's ``ops/pallas/``.
DEVICE_MODULE_PATHS: tuple[str, ...] = (
    "optuna_tpu_torch/ops/",
    # Redundant with the ops/ subtree, listed explicitly: the kernel
    # wrappers are the hardest-device code in the tree and must stay
    # classified even if the ops/ umbrella is ever narrowed.
    "optuna_tpu_torch/ops/kernels/",
    "optuna_tpu_torch/gp/",
    "optuna_tpu_torch/samplers/_tpe/_kernels.py",
    "optuna_tpu_torch/samplers/_resilience.py",
    "optuna_tpu_torch/parallel/executor.py",
    "optuna_tpu_torch/parallel/scan_loop.py",
    "optuna_tpu_torch/parallel/sharded.py",
)

#: The device programs of the eager port, as ``{path suffix: {function
#: qualname: what runs on the card}}``. The JAX package finds this scope
#: from ``jit`` decorators and ``lax`` loop bodies; the port has neither,
#: so the functions are named here. Every function lexically nested in a
#: named one is in scope too. Inside it **TPU001** flags host reads and
#: **OBS001** observability taps; a named function the module no longer
#: defines is itself a TPU001 finding, so this map cannot silently rot.
DEVICE_PROGRAMS: dict[str, dict[str, str]] = {
    "optuna_tpu_torch/parallel/scan_loop.py": {
        "_chunk_program": "one exact scan chunk: ask, evaluate and tell of a whole chunk on the card",
        "_chunk_program_sparse": "one sparse (SGPR) scan chunk on the card",
        "_seed_inducing_program": "the inducing-set seed of the sparse scan loop",
    },
    "optuna_tpu_torch/ops/lbfgsb.py": {
        "lbfgsb": "the batched L-BFGS-B loop every GP fit and acquisition ascent runs",
    },
    "optuna_tpu_torch/gp/fused.py": {
        "gp_suggest_fused": "the fused GP suggestion: fit, factor and acquisition ascent",
        "gp_suggest_chain_fused": "the speculative chain of fused suggestions",
    },
}

#: Reviewed host-boundary functions allowed to touch float64 inside device
#: modules, as ``{path suffix: {function name: reason}}``. These run on the
#: host (numpy / scipy), outside any device program; their f64 never reaches
#: the card. TPU003 skips them and flags everything else.
HOST_BOUNDARY_F64: dict[str, dict[str, str]] = {
    "optuna_tpu_torch/ops/forest.py": {
        "_make_bins": "host-side histogram bin building (numpy, pre-device)",
        "fit_forest": "host-side bin/target preparation before device transfer",
        "_export_tree": "host-side export of fitted trees back to numpy",
    },
    "optuna_tpu_torch/ops/cmaes.py": {
        "apply_margin": "host tell path: margin correction on the host copy of state",
        "should_stop": "host tell path: stop criteria on host numpy state",
    },
    "optuna_tpu_torch/ops/qmc.py": {
        "normal_qmc_sample": "host scipy ndtri path; eps guard is host-only",
    },
    "optuna_tpu_torch/gp/box_decomposition.py": {
        "nondominated_box_decomposition": "host-side box decomposition (numpy)",
    },
    "optuna_tpu_torch/gp/optim_mixed.py": {
        "eval_acqf_chunked": "host chunking wrapper around the jitted acqf",
        "continuous_bounds": "host-side bounds/mask construction (numpy, pre-device)",
        "snap_steps": "host-side rounding of a finished candidate",
        "_sweep_tables": "host-side construction of categorical sweep tables",
        "optimize_acqf_mixed": "host outer loop; device work happens in jitted callees",
        "optimize_acqf_sample": "host-side argmax over device-evaluated candidates",
    },
    "optuna_tpu_torch/gp/search_space.py": {
        "SearchSpace": "host-side search-space bounds/steps bookkeeping (numpy)",
    },
}

#: The JAX package's rules with no counterpart in the eager port, with the
#: reason. ``all_rules()`` does not run them; ``--list-rules`` shows them.
NOT_APPLICABLE_RULES: dict[str, str] = {
    "TPU002": (
        "jit recompile hazard: the port runs eagerly and builds no jit "
        "wrapper, so there is no executable cache to key unstably"
    ),
}
