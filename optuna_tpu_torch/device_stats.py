"""Device-stats taps: what the device programs did, published at the host
boundary (port of ``optuna_tpu/device_stats.py``).

**The convention.** A device program that has something to report returns
a small stats struct beside its primary outputs: a plain dict of scalars
whose keys come from the :data:`DEVICE_STATS` vocabulary. A value is a
0-dim tensor or a plain Python number (the port's chunk loops already hold
their verdict counts on the host).

**The harness.** :func:`harvest` publishes one struct into telemetry
gauges ``device.<stat>.<agg>`` (``max`` for high-water stats, ``total``
for accumulating ones, also observed into a ``device.<stat>`` histogram,
``last`` for point values), plus one flight ``gauge`` event per stat so
the timeline shows when the device did the work. It reads each value once,
after the caller has read the program's primary outputs. While telemetry
and the flight recorder are both off it returns after module-global checks
and allocates nothing.
"""

from __future__ import annotations

from typing import Mapping

from optuna_tpu_torch import flight, telemetry

__all__ = [
    "DEVICE_STATS",
    "STAT_AGGREGATIONS",
    "enabled",
    "gauge_name",
    "harvest",
    "stat_gauges",
]


#: The device-stat vocabulary: every key a harvested stats struct may carry,
#: with what each stat reports. :func:`harvest` rejects unknown names.
DEVICE_STATS: dict[str, str] = {
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

#: How each stat aggregates across harvests within one recording window:
#: ``max`` — high-water mark; ``total`` — running sum (also observed into a
#: histogram so the per-dispatch distribution survives); ``last`` — most
#: recent point value.
STAT_AGGREGATIONS: dict[str, str] = {
    "gp.ladder_rung": "max",
    "gp.fit_iterations": "total",
    "gp.proposal_fallback_coords": "total",
    "gp.best_acq": "last",
    "gp.inducing_count": "last",
    "gp.sparsity_ratio": "last",
    "gp.inducing_swaps": "total",
    "gp.sparse_heldout_err": "last",
    "executor.quarantined": "total",
    "scan.rank1_updates": "total",
    "scan.refactorizations": "total",
    "scan.quarantined": "total",
    "scan.chunk_fill": "last",
    "shard.width": "last",
    "shard.quarantined": "total",
    "shard.contained_groups": "total",
}

_GAUGE_PREFIX = "device."


def enabled() -> bool:
    """Whether a harvest would publish anywhere: the call sites' cheap
    pre-check before building a stats mapping that only exists for
    harvesting."""
    return telemetry.enabled() or flight.enabled()


def gauge_name(stat: str) -> str:
    """The telemetry gauge a stat publishes to (``device.<stat>.<agg>``)."""
    return f"{_GAUGE_PREFIX}{stat}.{STAT_AGGREGATIONS[stat]}"


def harvest(stats: Mapping[str, object], trial: int | None = None) -> None:
    """Publish one program's device-stat struct at the host boundary.

    ``stats`` maps :data:`DEVICE_STATS` names to 0-dim tensors or plain
    numbers; each value is read once (``float``). Per stat: the aggregated
    gauge, a histogram observation for ``total`` stats, and one flight
    ``gauge`` event (optionally trial-tagged). A no-op while telemetry and
    flight are both disabled.
    """
    if not telemetry.enabled() and not flight.enabled():
        return
    for name, value in stats.items():
        agg = STAT_AGGREGATIONS.get(name)
        if agg is None:
            raise ValueError(
                f"unknown device stat {name!r}; the vocabulary is {sorted(DEVICE_STATS)}."
            )
        v = float(value)
        gauge = f"{_GAUGE_PREFIX}{name}.{agg}"
        if agg == "max":
            telemetry.max_gauge(gauge, v)
        elif agg == "total":
            telemetry.add_gauge(gauge, v)
            telemetry.observe(_GAUGE_PREFIX + name, v)
        else:  # "last"
            telemetry.set_gauge(gauge, v)
        flight.event("gauge", _GAUGE_PREFIX + name, trial=trial, meta={"value": v})


def stat_gauges(snapshot: Mapping | None = None) -> dict[str, float]:
    """The ``device.*`` gauges from a telemetry snapshot. Only stats that
    actually harvested appear."""
    snap = telemetry.snapshot() if snapshot is None else snapshot
    return {
        name: value
        for name, value in snap.get("gauges", {}).items()
        if name.startswith(_GAUGE_PREFIX)
    }
