"""Autopilot: a doctor-driven remediation control loop with guarded actions
(port of ``optuna_tpu/autopilot.py``).

The study doctor (:mod:`optuna_tpu_torch.health`) diagnoses; this module
acts on its findings at the trial/batch/chunk boundaries every optimize
loop already visits, through a small vocabulary of **guarded actions**
(:data:`ACTIONS`, the reference's, each with a scenario in
``testing/fault_injection.py::AUTOPILOT_CHAOS_MATRIX``):

==========================  ===============================================
finding                     action
==========================  ===============================================
``study.stagnation``        ``sampler.restart`` — reseed the wrapped
                            sampler and run a bounded independent
                            exploration burst through
                            :meth:`GuardedSampler.pin_independent`
``sampler.fallback_storm``  ``sampler.pin_independent`` — pre-emptively pin
                            the independent path for N trials instead of
                            paying a failed fit per trial
``jit.retrace_churn``       ``executor.pin_shapes`` — freeze the executor's
                            batch width at the dominant compiled width
``executor.quarantine_rate``  ``executor.tighten_regrowth`` — stretch the
                            probationary batch-regrowth streak
``service.slo_burn`` /      ``service.shed_earlier`` — halve the shed
``service.backpressure``    thresholds of the suggestion hub (the
                            ``SuggestService`` noted last) and double its
                            ``ready_ahead``
``gp.sparse_degraded``      ``gp.densify`` — double the scan loop's (or the
                            GP sampler's) inducing capacity, or fall back to
                            the exact posterior once at the cap
==========================  ===============================================

Every action is **dry-run by default** (``mode="observe"`` records the
would-have-acted decision — counter, flight event, in-memory log — and
mutates nothing; ``mode="act"`` executes), rate-limited per check
(``cooldown_s``), bounded by a per-loop ``budget``, **reversible** (each
executed action records its undo and rolls back after ``rollback_after``
finished trials with no improvement in the triggering finding), counted in
telemetry (``autopilot.action.<id>``, flight-recorded through the counter
sink), and mirrored into study system attrs (``autopilot:action:<seq>``,
act mode only) for audit through ``optuna-tpu-torch autopilot`` and
``/autopilot.json``.

Diagnosis is **process-local**: the loop reads this worker's own telemetry
deltas, jit totals and SLO verdicts and the trial history, so a decision
never blocks on — or mutates — the fleet channel, and the observe twin of
a study is identical to the autopilot-off twin.

**Off by default**; the disabled hot path (:func:`maybe_step`) is one dict
lookup and allocates nothing per trial. Enable with
``OPTUNA_TPU_TORCH_AUTOPILOT=1`` (observe) / ``OPTUNA_TPU_TORCH_AUTOPILOT=act``,
or :func:`enable` / ``Study(autopilot=...)`` /
``optimize_vectorized(autopilot=...)`` at runtime.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Mapping

from optuna_tpu_torch import health, locksan, telemetry
from optuna_tpu_torch.logging import get_logger, warn_once

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)

__all__ = [
    "ACTIONS",
    "ACTION_TRIGGERS",
    "MODES",
    "ActionRecord",
    "Autopilot",
    "AutopilotPolicy",
    "action_for",
    "attach",
    "disable",
    "enable",
    "enabled",
    "export_report",
    "maybe_step",
    "mode",
    "render_text",
]


# ------------------------------------------------------------- vocabulary

#: The guarded-action vocabulary: every remediation this loop can decide
#: carries exactly one of these ids. Equal to the reference's, and
#: ``tests/test_torch_autopilot.py`` asserts the trigger table below and
#: the chaos matrix cover exactly this set.
ACTIONS: dict[str, str] = {
    "sampler.restart": "study.stagnation -> reseed + a bounded independent exploration burst via GuardedSampler",
    "sampler.pin_independent": "sampler.fallback_storm -> pre-emptively pin the independent path for N trials (skip the failing fit)",
    "executor.pin_shapes": "jit.retrace_churn -> freeze the executor's batch width at the dominant compiled width",
    "executor.tighten_regrowth": "executor.quarantine_rate -> stretch the executor's probationary batch-regrowth streak",
    "service.shed_earlier": "service.slo_burn/service.backpressure -> halve the shed thresholds and widen ready-queue prewarm",
    "gp.densify": "gp.sparse_degraded -> widen the sparse GP engine: double the inducing capacity, or fall back to the exact posterior once at cap",
}

#: Which doctor findings trigger which action. Keys are exactly
#: :data:`ACTIONS`; every trigger is a :data:`~optuna_tpu_torch.health.
#: HEALTH_CHECKS` id (both asserted by the chaos suite).
ACTION_TRIGGERS: dict[str, tuple[str, ...]] = {
    "sampler.restart": ("study.stagnation",),
    "sampler.pin_independent": ("sampler.fallback_storm",),
    "executor.pin_shapes": ("jit.retrace_churn",),
    "executor.tighten_regrowth": ("executor.quarantine_rate",),
    "service.shed_earlier": ("service.slo_burn", "service.backpressure"),
    "gp.densify": ("gp.sparse_degraded",),
}

#: Operating modes. ``observe`` (the default) records would-have-acted
#: decisions and mutates nothing; ``act`` executes them.
MODES: tuple[str, ...] = ("observe", "act")

_CHECK_TO_ACTION: dict[str, str] = {
    check: action
    for action, checks in ACTION_TRIGGERS.items()
    for check in checks
}

#: The doctor checks the loop evaluates (exactly the union of triggers —
#: the control loop must never pay for checks it cannot act on).
_TRIGGER_CHECKS: tuple[str, ...] = tuple(sorted(_CHECK_TO_ACTION))

#: Study system-attr namespace act-mode decisions are mirrored under (one
#: attr per decision, overwritten in place when its state changes).
ACTION_ATTR_PREFIX = "autopilot:action:"

#: Monotonic autopilot tokens (the GuardedSampler pattern: ``id(self)``
#: recycles after GC and would alias warn-once keys).
_autopilot_seq = itertools.count()


def action_for(check: str) -> str | None:
    """The action id a finding with this check id triggers, or None when
    the autopilot has no remediation for it (most checks: the doctor's
    vocabulary is wider than the actuator vocabulary on purpose — an
    action needs a knob that provably helps, not just a diagnosis)."""
    return _CHECK_TO_ACTION.get(check)


# ----------------------------------------------------------------- policy


@dataclass(frozen=True)
class AutopilotPolicy:
    """The guardrails one control loop runs under.

    ``mode`` picks observe (decisions logged, nothing mutated) or act;
    ``interval_s`` rate-limits the whole step (diagnosis is O(trials));
    ``cooldown_s`` is the per-check floor between decisions — the
    anti-action-storm guard; ``budget`` bounds total decisions over the
    loop's lifetime (one loop per study object; observe and act consume
    it alike, so the observe log predicts the act log — ``no_target``
    decisions are free: a knob the loop could not have turned must not
    starve the ones it can);
    ``rollback_after`` is how many newly finished trials an executed
    action gets to improve its finding before its undo runs;
    ``pin_trials`` sizes the independent pin / exploration burst;
    ``regrowth_streak`` is the tightened probation length;
    ``overrides`` are :func:`optuna_tpu_torch.health.diagnose` threshold
    overrides (e.g. ``stagnation_window``); ``clock`` is injectable for
    deterministic tests (monotonic seconds).
    """

    mode: str = "observe"
    interval_s: float = 5.0
    cooldown_s: float = 60.0
    budget: int = 8
    rollback_after: int = 8
    pin_trials: int = 16
    regrowth_streak: int = 8
    overrides: Mapping[str, Any] = field(default_factory=dict)
    clock: Callable[[], float] = time.monotonic
    now: Callable[[], float] = time.time

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES}; got {self.mode!r}."
            )
        if self.budget < 0 or self.rollback_after < 1 or self.pin_trials < 1:
            raise ValueError(
                "budget must be >= 0, rollback_after and pin_trials >= 1; "
                f"got {self.budget}, {self.rollback_after}, {self.pin_trials}."
            )


def _coerce_policy(config: "str | AutopilotPolicy | None") -> AutopilotPolicy:
    if isinstance(config, AutopilotPolicy):
        return config
    if config is None:
        return AutopilotPolicy(mode=_mode, interval_s=_interval_s)
    if isinstance(config, str):
        return AutopilotPolicy(mode=config)
    raise TypeError(
        f"autopilot must be an AutopilotPolicy, a mode string {MODES}, or "
        f"None; got {type(config).__name__}."
    )


# ----------------------------------------------------------------- record


@dataclass
class ActionRecord:
    """One decision the loop took: which action, on which finding's
    evidence, in which mode, and what became of it."""

    seq: int
    action: str
    check: str
    mode: str
    decided_unix: float
    evidence: dict[str, Any]
    #: ``observed`` (dry-run), ``executed`` (undo armed), ``no_target``
    #: (the actuator was not reachable from this loop), then terminal
    #: ``held`` (finding improved, undo retired) or ``rolled_back``.
    state: str
    cooldown_until: float = 0.0
    finished_at_decision: int = 0

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown autopilot action {self.action!r}; the vocabulary "
                f"is {sorted(ACTIONS)} (ACTIONS / AUTOPILOT_ACTION_REGISTRY)."
            )

    def to_dict(self) -> dict[str, Any]:
        return {
            "seq": self.seq,
            "action": self.action,
            "check": self.check,
            "mode": self.mode,
            "decided_unix": self.decided_unix,
            "evidence": dict(self.evidence),
            "state": self.state,
        }


# ------------------------------------------------------------ the loop


class Autopilot:
    """One control loop = one (study, policy) pair, stepping at the
    boundaries its optimize loop already visits.

    Action targets are bound per boundary call, not constructed here: the
    batch executor passes itself at every batch boundary, the suggestion
    hub passes itself from its tell observer — an action whose target is
    not reachable from the current loop records ``no_target`` instead of
    guessing at a knob it cannot see.
    """

    def __init__(self, study: "Study", policy: AutopilotPolicy | None = None) -> None:
        from optuna_tpu_torch import flight, slo

        self._study = study
        self.policy = policy if policy is not None else AutopilotPolicy()
        self._token = next(_autopilot_seq)
        self._log: list[ActionRecord] = []
        self._undo: dict[int, Callable[[], None]] = {}
        self._cooldown_until: dict[str, float] = {}
        self._budget_left = self.policy.budget
        self._last_step: float | None = None
        # Reentrant: maybe_step -> step nest on the stepping thread, and
        # report() (the /autopilot.json handler's thread) takes the same
        # lock so a scrape never iterates the log/cooldowns mid-mutation.
        self._step_lock = locksan.rlock("autopilot.step")
        self._executor_ref: weakref.ReferenceType | None = None
        self._service_ref: weakref.ReferenceType | None = None
        # Process-local delta baselines (the HealthReporter discipline): a
        # previous study's counters in the process-global registry must not
        # trip this study's triggers.
        baseline = telemetry.snapshot()
        self._baseline_counters: dict[str, int] = dict(baseline.get("counters", {}))
        self._baseline_jit: dict[str, dict] = flight.jit_totals()
        self._baseline_slo: dict[str, tuple[int, int]] = slo.cumulative_counts()

    # --------------------------------------------------------------- step

    def maybe_step(self, executor: Any = None, service: Any = None) -> bool:
        """Rate-limited :meth:`step`; returns True when a step ran. Safe to
        call from concurrent boundaries (service tell observers race the
        optimize loop): a step already in progress is skipped, never
        queued — the next boundary re-offers."""
        t = self.policy.clock()
        if (
            self._last_step is not None
            and t - self._last_step < self.policy.interval_s
        ):
            return False
        if not self._step_lock.acquire(blocking=False):
            return False
        try:
            self._last_step = t
            self.step(executor=executor, service=service)
        finally:
            self._step_lock.release()
        return True

    def step(self, executor: Any = None, service: Any = None) -> list[ActionRecord]:
        """One unconditional control-loop pass: roll back stale actions,
        diagnose, decide, (in act mode) execute. Returns the records
        decided this pass. Best-effort by contract: a storage blip while
        reading the trial history degrades to \"no step\", never an abort
        of the loop that called us."""
        if executor is not None:
            self._executor_ref = weakref.ref(executor)
        if service is not None:
            self._service_ref = weakref.ref(service)
        study = self._study
        try:
            trials = study._storage.get_all_trials(study._study_id, deepcopy=False)
            directions = study.directions
        except Exception as err:  # graphlint: ignore[PY001] -- best-effort diagnosis: a storage blip while reading history must not abort the optimize loop driving this step
            _logger.info(f"autopilot step skipped after read error: {err!r}")
            return []
        fleet = self._local_fleet()
        findings = {
            f.check: f
            for f in health.diagnose(
                fleet, trials, directions,
                checks=_TRIGGER_CHECKS, **dict(self.policy.overrides),
            )
        }
        n_finished = sum(1 for t in trials if t.state.is_finished())
        with self._step_lock:
            self._rollback_pass(findings, n_finished)
            decided: list[ActionRecord] = []
            t = self.policy.clock()
            for check in _TRIGGER_CHECKS:
                finding = findings.get(check)
                if finding is None:
                    continue
                if self._cooldown_until.get(check, 0.0) > t:
                    continue  # per-check cooldown: no action storms
                if self._standing(check):
                    # The check's action is already in effect (executed,
                    # pending its rollback verdict) or proved itself
                    # (held): re-deciding would stack a non-idempotent
                    # knob turn on top of itself every cooldown — one
                    # transient backpressure burst must not ratchet the
                    # shed thresholds to the floor. Only a rolled-back
                    # (or target-less) decision re-arms after cooldown.
                    continue
                if self._budget_left <= 0:
                    warn_once(
                        _logger,
                        f"autopilot_budget:{self._token}",
                        f"autopilot action budget ({self.policy.budget}) is "
                        "spent; further findings are diagnosed but no longer "
                        "acted on by this loop.",
                    )
                    break
                decided.append(self._decide(finding, n_finished))
            return decided

    def _standing(self, check: str) -> bool:
        """Does this check already have an action in effect (executed) or
        proven (held)? Observe-mode records never stand — they hold no
        knob."""
        return any(
            r.check == check and r.state in ("executed", "held")
            for r in self._log
        )

    def _decide(self, finding: "health.HealthFinding", n_finished: int) -> ActionRecord:
        action = _CHECK_TO_ACTION[finding.check]
        policy = self.policy
        record = ActionRecord(
            seq=len(self._log),
            action=action,
            check=finding.check,
            mode=policy.mode,
            decided_unix=policy.now(),
            evidence=dict(finding.evidence),
            state="observed",
            cooldown_until=policy.clock() + policy.cooldown_s,
            finished_at_decision=n_finished,
        )
        self._cooldown_until[finding.check] = record.cooldown_until
        target = self._resolve_target(action)
        if target is None:
            # Resolved in BOTH modes (observe parity), before the budget:
            # a persistent finding whose actuator this loop cannot reach
            # (e.g. an SLO burn in a worker with no hub) must not drain
            # the budget actionable findings need — the cooldown alone
            # keeps the no_target log quiet.
            record.state = "no_target"
        else:
            self._budget_left -= 1
            if policy.mode == "act":
                undo = self._execute(action, target)
                record.state = "executed"
                self._undo[record.seq] = undo
        self._log.append(record)
        # One counter per decision (flight-recorded through the counter
        # sink): the vocabulary-bounded audit trail observe and act share.
        telemetry.count(
            "autopilot.action." + action,
            meta={"check": finding.check, "mode": policy.mode, "state": record.state},
        )
        _logger.warning(
            f"autopilot[{policy.mode}]: {finding.check} -> {action} "
            f"({record.state}); evidence {record.evidence}"
        )
        self._mirror(record)
        return record

    # ----------------------------------------------------------- rollback

    def _rollback_pass(self, findings: Mapping[str, Any], n_finished: int) -> None:
        """Reversibility: an executed action that has had its chance
        (``rollback_after`` newly finished trials) and whose finding shows
        no improvement is undone — a remediation that does not remediate
        must not outlive its evidence."""
        for record in self._log:
            if record.state != "executed":
                continue
            if (
                n_finished - record.finished_at_decision
                < self.policy.rollback_after
            ):
                continue
            current = findings.get(record.check)
            if self._improved(record, current):
                record.state = "held"
                self._undo.pop(record.seq, None)
                telemetry.count("autopilot.action.held", meta=record.to_dict())
            else:
                undo = self._undo.pop(record.seq, None)
                if undo is not None:
                    try:
                        undo()
                    except Exception as err:  # graphlint: ignore[PY001] -- the undo is best-effort restoration of a knob; a failure to restore must not abort the optimize loop (the action log records the attempt)
                        _logger.warning(
                            f"autopilot undo for {record.action} raised "
                            f"{err!r}; the knob may retain the acted value."
                        )
                record.state = "rolled_back"
                # Re-arm the cooldown from now: an action that just failed
                # must not be re-decided at the very next boundary.
                record.cooldown_until = (
                    self.policy.clock() + self.policy.cooldown_s
                )
                self._cooldown_until[record.check] = record.cooldown_until
                telemetry.count("autopilot.action.rollback", meta=record.to_dict())
                _logger.warning(
                    f"autopilot: rolled back {record.action} — "
                    f"{record.check} did not improve over "
                    f"{self.policy.rollback_after} finished trials."
                )
            self._mirror(record)

    @staticmethod
    def _improved(record: ActionRecord, finding: Any) -> bool:
        """Did the triggering finding improve since the action fired? Gone
        is always improvement; otherwise each check has one progress
        reading: stagnation = the best value moved, rate checks = the rate
        fell, retrace churn = no *new* retraces, service checks = the
        shed/burn totals stopped growing."""
        if finding is None:
            return True
        old, new = record.evidence, finding.evidence
        check = record.check
        if check == "study.stagnation":
            return new.get("best_value") != old.get("best_value")
        if check in ("sampler.fallback_storm", "executor.quarantine_rate"):
            return new.get("rate", 1.0) < old.get("rate", 0.0)
        if check == "jit.retrace_churn":
            return new.get("retraces_after_first", 0) <= old.get(
                "retraces_after_first", 0
            )
        if check == "service.backpressure":
            return new.get("total", 0) <= old.get("total", 0)
        if check == "gp.sparse_degraded":
            return new.get("heldout_err", float("inf")) < old.get(
                "heldout_err", 0.0
            )
        if check == "service.slo_burn":
            old_burn = max(
                (s.get("burn_long", 0.0) for s in old.get("slos", {}).values()),
                default=0.0,
            )
            new_burn = max(
                (s.get("burn_long", 0.0) for s in new.get("slos", {}).values()),
                default=0.0,
            )
            return new_burn < old_burn
        return False

    # ---------------------------------------------------------- actuators

    def _resolve_target(self, action: str) -> Any:
        """The actuator object an action would turn, or None when it is
        not reachable from this loop (recorded as ``no_target`` in both
        modes — never a guess at a knob we cannot see, never a budget
        charge for a knob we could not have turned)."""
        if action.startswith("sampler."):
            return self._guarded_sampler()
        if action.startswith("executor."):
            return self._executor_ref() if self._executor_ref is not None else None
        if action == "service.shed_earlier":
            service = self._service_ref() if self._service_ref is not None else None
            return service if service is not None else _noted_service()
        if action == "gp.densify":
            # Two actuator shapes, scan loop first: optimize_scan registers
            # its live threshold dict on the study; a per-trial study instead
            # exposes the knob through its (possibly Guarded-wrapped)
            # sampler. Neither present -> no_target, the honest verdict.
            control = getattr(self._study, "_scan_gp_control", None)
            if isinstance(control, dict):
                return control
            sampler = self._study.sampler
            # Probe through GuardedSampler: its delegation method always
            # exists, but only a wrapped engine that itself has the knob
            # can honour the call.
            inner = getattr(sampler, "sampler", sampler)
            return (
                sampler if hasattr(inner, "autopilot_densify") else None
            )
        raise AssertionError(f"unreachable: unknown action {action!r}")

    def _execute(self, action: str, target: Any) -> Callable[[], None]:
        """Run one action against its resolved target; returns the undo."""
        if action == "sampler.restart":
            # Perturb, then explore: a fresh RNG stream plus a bounded
            # burst of independent trials is the restart GuardedSampler's
            # fallback machinery can actually deliver (and undo).
            target.reseed_rng()
            token = target.pin_independent(
                self.policy.pin_trials, reason="autopilot: stagnation exploration burst"
            )

            def undo_restart() -> None:
                target.unpin_independent(token)

            return undo_restart
        if action == "sampler.pin_independent":
            token = target.pin_independent(
                self.policy.pin_trials,
                reason="autopilot: fallback storm — skip the failing fit",
            )

            def undo_pin() -> None:
                target.unpin_independent(token)

            return undo_pin
        if action == "executor.pin_shapes":
            return target.autopilot_pin_batch_width()
        if action == "executor.tighten_regrowth":
            return target.autopilot_tighten_regrowth(self.policy.regrowth_streak)
        if action == "service.shed_earlier":
            return _shed_earlier(target)
        if action == "gp.densify":
            return _densify(target)
        raise AssertionError(f"unreachable: unknown action {action!r}")

    def _guarded_sampler(self) -> Any:
        sampler = self._study.sampler
        return sampler if hasattr(sampler, "pin_independent") else None

    # -------------------------------------------------------------- fleet

    def _local_fleet(self) -> dict[str, Any]:
        """A fleet-shaped view of THIS process only: telemetry counter
        deltas since attach, ``jit`` totals deltas, and the SLO engine's
        verdicts — everything the trigger checks read, none of the storage
        round-trips the real fleet channel pays."""
        from optuna_tpu_torch import flight, slo

        snap = telemetry.snapshot()
        counters: dict[str, int] = {}
        for name, value in snap.get("counters", {}).items():
            delta = value - self._baseline_counters.get(name, 0)
            if delta > 0:
                counters[name] = delta
        jit: dict[str, dict] = {}
        for label, totals in flight.jit_totals().items():
            base = self._baseline_jit.get(label, {})
            delta = {
                "compiles": totals["compiles"] - base.get("compiles", 0),
                "retraces_after_first": totals["retraces_after_first"]
                - base.get("retraces_after_first", 0),
            }
            if delta["compiles"] > 0 or delta["retraces_after_first"] > 0:
                jit[label] = delta
        # Device-stat gauges pass through live (not as deltas): the checks
        # that read them (gp.sparse_degraded, gp.ladder_escalation via the
        # fleet channel) threshold current values, and "last"/"max"
        # aggregated gauges have no meaningful baseline subtraction.
        gauges = {
            name: value
            for name, value in snap.get("gauges", {}).items()
            if name.startswith("device.")
        }
        return {
            "workers": [],
            "n_workers": 0,
            "n_alive": 0,
            "counters": counters,
            "gauges": gauges,
            "histograms": {},
            "jit": jit,
            "slo": slo.worker_snapshot(self._baseline_slo),
        }

    # -------------------------------------------------------------- audit

    def _mirror(self, record: ActionRecord) -> None:
        """Mirror one decision into the study's system attrs (act mode
        only: the observe twin must mutate nothing, and its log lives on
        this object + the counters). Best-effort: the attr is audit, and a
        storage blip on it must never become a study failure."""
        if self.policy.mode != "act":
            return
        study = self._study
        try:
            study._storage.set_study_system_attr(
                study._study_id,
                f"{ACTION_ATTR_PREFIX}{record.seq:04d}",
                record.to_dict(),
            )
        except Exception as err:  # graphlint: ignore[PY001] -- the audit attr is diagnostics; a storage blip on it must not turn a working remediation into a study abort
            warn_once(
                _logger,
                f"autopilot_mirror:{self._token}",
                f"mirroring autopilot action {record.seq} raised {err!r}; "
                "the in-process log keeps the record.",
            )

    def report(self) -> dict[str, Any]:
        """The audit view one loop serves (``/autopilot.json`` aggregates
        these; ``optuna-tpu-torch autopilot`` renders them): policy, budget,
        per-action records, live cooldown clocks. Takes the step lock so a
        concurrent scrape never iterates the log mid-mutation."""
        with self._step_lock:
            return self._report_locked()

    def _report_locked(self) -> dict[str, Any]:
        t = self.policy.clock()
        return {
            "study": self._study.study_name,
            "mode": self.policy.mode,
            "budget": self.policy.budget,
            "budget_left": self._budget_left,
            "actions": [
                {
                    **record.to_dict(),
                    "cooldown_remaining_s": round(
                        max(0.0, record.cooldown_until - t), 3
                    ),
                    "undo_pending": record.seq in self._undo,
                }
                for record in self._log
            ],
            "cooldowns": {
                check: round(max(0.0, until - t), 3)
                for check, until in sorted(self._cooldown_until.items())
                if until > t
            },
        }


def _shed_earlier(service: Any) -> Callable[[], None]:
    """The service actuator: halve every shed threshold (shed earlier) and
    double ``ready_ahead`` (wider speculative prewarm absorbs more of the
    burst), returning the undo that restores both."""
    policy = service.shed_policy
    previous = (
        policy.degrade_depth,
        policy.independent_depth,
        policy.reject_depth,
        service.ready_ahead,
    )
    policy.degrade_depth = max(1, policy.degrade_depth // 2)
    policy.independent_depth = max(1, policy.independent_depth // 2)
    policy.reject_depth = max(1, policy.reject_depth // 2)
    service.ready_ahead = max(1, service.ready_ahead * 2)

    def undo() -> None:
        (
            policy.degrade_depth,
            policy.independent_depth,
            policy.reject_depth,
            service.ready_ahead,
        ) = previous

    return undo


def _densify(target: Any) -> Callable[[], None]:
    """The sparse-GP actuator (``gp.densify``): widen the engine one notch.

    On a scan-loop control dict (``study._scan_gp_control``): double the
    inducing capacity up to :data:`~optuna_tpu_torch.gp.sparse.N_INDUCING_MAX`;
    once at cap, raise the exact-size threshold out of reach so every later
    chunk takes the exact posterior — the most accurate (and most
    expensive) setting, which is why each firing moves one notch and the
    rollback pass restores the previous thresholds if the held-out error
    does not improve. On a sampler actuator: delegate to its
    ``autopilot_densify`` (which applies the same ladder to its own knobs
    and returns its own undo)."""
    if isinstance(target, dict):
        from optuna_tpu_torch.gp.sparse import N_INDUCING_MAX

        previous = dict(target)
        m = int(target.get("n_inducing", N_INDUCING_MAX))
        if m < N_INDUCING_MAX:
            target["n_inducing"] = min(2 * m, N_INDUCING_MAX)
        else:
            # At capacity: the approximation itself is the problem — route
            # back to the exact posterior (reversible, like every action).
            target["n_exact_max"] = _DENSIFY_EXACT_LIMIT

        def undo() -> None:
            target.clear()
            target.update(previous)

        return undo
    return target.autopilot_densify()


#: The "effectively exact" threshold gp.densify pins when the inducing
#: capacity is already at cap: no realistic study exceeds it, so the scan
#: loop routes every later chunk through the exact program.
_DENSIFY_EXACT_LIMIT = 10**9


# ------------------------------------------------- module-level fast path

_enabled = False
_mode = "observe"
_interval_s = 5.0

#: Live loops for the process-wide surfaces (weak: a study's end-of-life
#: must not be extended by its audit view).
_LIVE: "weakref.WeakValueDictionary[int, Autopilot]" = weakref.WeakValueDictionary()

#: The last-constructed suggestion service (weak), so a hub whose optimize
#: loops run in other processes can still be the shed actuator's target.
_SERVICE_REF: weakref.ReferenceType | None = None


def note_service(service: Any) -> None:
    """Register the suggestion hub as a reachable action target (called by
    ``SuggestService.__init__``; one line, no behavior while disabled)."""
    global _SERVICE_REF
    _SERVICE_REF = weakref.ref(service)


def _noted_service() -> Any:
    return _SERVICE_REF() if _SERVICE_REF is not None else None


def _env_mode() -> str | None:
    """``OPTUNA_TPU_TORCH_AUTOPILOT``: unset/empty/0/false/no/off stay disabled
    (the flight/health opt-out spellings), ``act`` arms the acting loop,
    anything else arms observe."""
    raw = os.environ.get("OPTUNA_TPU_TORCH_AUTOPILOT", "").strip()
    if not raw or raw.lower() in ("0", "false", "no", "off"):
        return None
    return "act" if raw.lower() == "act" else "observe"


def enabled() -> bool:
    return _enabled


def mode() -> str:
    """The module-level default mode new loops inherit."""
    return _mode


def enable(mode: str = "observe", *, interval_s: float | None = None) -> None:
    """Arm the control loop for studies this process subsequently drives
    (per-study ``Study(autopilot=...)`` / ``optimize_vectorized(
    autopilot=...)`` knobs work without this). A study already carrying a
    loop keeps it."""
    global _enabled, _mode, _interval_s
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}.")
    _mode = mode
    if interval_s is not None:
        _interval_s = float(interval_s)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def attach(
    study: "Study", *, config: "str | AutopilotPolicy | None" = None
) -> Autopilot | None:
    """Attach a control loop to ``study`` now (no step yet): called at
    every optimize loop's entry so the delta baselines are captured before
    the run records anything. A no-op returning None unless ``config``,
    the study's own ``autopilot=`` knob, or the module switch opted in;
    idempotent (an existing loop keeps its baselines, log, and budget —
    a *different* explicit config arriving for a study that already
    carries a loop is warned about and ignored, never silently honored
    or silently dropped)."""
    existing = study.__dict__.get("_autopilot")
    if existing is not None:
        if config is not None and _coerce_policy(config).mode != existing.policy.mode:
            warn_once(
                _logger,
                f"autopilot_reattach:{existing._token}",
                f"study {study.study_name!r} already carries an autopilot "
                f"loop in mode={existing.policy.mode!r}; the new autopilot= "
                f"config (mode={_coerce_policy(config).mode!r}) is ignored "
                "for this study object — build a fresh Study to change "
                "modes.",
            )
        return existing
    if config is None:
        config = study.__dict__.get("_autopilot_request")
    if config is None and not _enabled:
        return None
    pilot = Autopilot(study, _coerce_policy(config))
    study.__dict__["_autopilot"] = pilot
    _LIVE[pilot._token] = pilot
    return pilot


def maybe_step(study: "Study", executor: Any = None, service: Any = None) -> None:
    """The trial/batch/chunk-boundary hook the optimize loops call: a
    rate-limited control-loop pass. A no-op (one dict lookup, zero
    allocations) while no loop is attached."""
    pilot = study.__dict__.get("_autopilot")
    if pilot is None:
        return
    pilot.maybe_step(executor=executor, service=service)


def export_report() -> dict[str, Any]:
    """The process-wide report shape ``/autopilot.json`` serves (the
    ``/slo.json`` enabled-flag contract): module state plus one report per
    live loop."""
    reports = [pilot.report() for _, pilot in sorted(_LIVE.items())]
    return {
        "enabled": _enabled or bool(reports),
        "mode": _mode,
        "generated_unix": time.time(),
        "autopilots": reports,
    }


def render_text(report: Mapping[str, Any]) -> str:
    """The ``optuna-tpu-torch autopilot`` table rendering of one export (or one
    storage-reconstructed report): per-loop header, then one line per
    action with its finding evidence, undo state, and cooldown clock."""
    lines: list[str] = []
    if not report.get("enabled", True) and not report.get("autopilots"):
        return (
            "autopilot: not armed (enable with OPTUNA_TPU_TORCH_AUTOPILOT=1/act, "
            "autopilot.enable(), or Study(autopilot=...))"
        )
    for pilot in report.get("autopilots", ()):
        head = f"study {pilot.get('study')!r}: mode={pilot.get('mode')}"
        if pilot.get("budget") is not None:
            head += f" budget={pilot.get('budget_left')}/{pilot.get('budget')}"
        lines.append(head)
        actions = pilot.get("actions", ())
        if not actions:
            lines.append("  (no actions decided)")
        for record in actions:
            lines.append(
                f"  [{record.get('seq')}] {record.get('check')} -> "
                f"{record.get('action')}: {record.get('state')}"
                + (
                    f" (undo pending, cooldown "
                    f"{record.get('cooldown_remaining_s')}s)"
                    if record.get("undo_pending")
                    else ""
                )
            )
            for key in sorted(record.get("evidence", {})):
                lines.append(f"      {key}: {record['evidence'][key]}")
        cooldowns = pilot.get("cooldowns", {})
        for check in sorted(cooldowns):
            lines.append(f"  cooldown {check}: {cooldowns[check]}s remaining")
    return "\n".join(lines)


# The environment switch mirrors telemetry's/flight's/health's: set before
# import, the loop is armed from trial zero.
_initial_mode = _env_mode()
if _initial_mode is not None:
    enable(_initial_mode)
