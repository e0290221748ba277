"""graphlint for the PyTorch port: the JAX package's AST-based invariant
checker, pointed at ``optuna_tpu_torch``, with eager counterparts of the
device rules.

Run it::

    python -m optuna_tpu_torch._lint optuna_tpu_torch   # or: optuna-tpu-torch-lint

Rules (the JAX package's ids, so a suppression reads the same in both):

=======  ================================================================
TPU001   host read (.item()/.cpu()/float()/...) inside a device program
TPU003   float64, or TF32 switched on, in an f32-hardened device module
TPU004   stray print / breakpoint in package code
OBS001   telemetry/flight/device-stats/logging call inside a device program
OBS002   flight-recorder event vocabularies drifted from the canonical one
OBS003   device-stat vocabularies drifted from the canonical one
OBS004   study-doctor check vocabularies drifted from the canonical one
OBS005   SLO objective vocabularies drifted from the canonical one
STO001   replay-unsafe write registries drifted from the canonical one
STO002   lock-order cycle in the storage layer
CONC001  interprocedural lock-order cycle (package-wide, self-call aware)
CONC002  blocking call under a held lock on a serve hot path
CONC003  thread-shared attribute written outside a lock
CONC004  lock sanitizer vocabularies drifted from the canonical one
SRV001   suggestion-service shed policy sets drifted from the canonical one
ACT001   autopilot action vocabularies drifted from the canonical one
FLT001   hub-fleet event vocabularies drifted from the canonical one
FLT002   lease/fence event vocabularies drifted from the canonical one
CKPT001  checkpoint event vocabularies drifted from the canonical one
EXE001   non-finite quarantine policy sets drifted from the canonical one
SMP001   sampler fallback policy sets drifted from the canonical one
SMP002   bare cholesky/cholesky_ex in sampler code (route through ladder_cholesky)
PY001    broad ``except Exception`` without a documented reason
LNT000   file failed to parse
LNT001   malformed suppression pragma (reason is mandatory)
=======  ================================================================

TPU002 (jit recompile hazard) has no eager counterpart and does not run:
``registry.NOT_APPLICABLE_RULES`` gives the reason, ``--list-rules`` shows it.

Suppression: ``# graphlint: ignore[RULE] -- reason`` (reason required).
Configuration: ``config.py``'s defaults, or ``[tool.graphlint-torch]`` in pyproject.toml.
"""

from __future__ import annotations

from optuna_tpu_torch._lint.engine import (  # noqa: F401 (public surface)
    BAD_PRAGMA_RULE,
    Finding,
    LintResult,
    PARSE_ERROR_RULE,
    Rule,
    run_lint,
)
from optuna_tpu_torch._lint.config import Config, find_pyproject, load_config  # noqa: F401


def all_rules() -> list[Rule]:
    """One fresh instance of every graphlint rule the port runs, in reporting
    order (``registry.NOT_APPLICABLE_RULES`` are not among them)."""
    from optuna_tpu_torch._lint.rules_device import (
        OBS001TelemetryInTrace,
        OBS002FlightEventSync,
        OBS003DeviceStatSync,
        OBS004HealthCheckSync,
        OBS005SloRegistrySync,
        TPU001HostSyncInJit,
        TPU003DtypeDrift,
        TPU004StrayDebugOutput,
    )
    from optuna_tpu_torch._lint.rules_concurrency import (
        CONC001LockOrder,
        CONC002BlockingUnderLock,
        CONC003ThreadSharedWrite,
        CONC004LocksanRegistrySync,
    )
    from optuna_tpu_torch._lint.rules_py import PY001BroadExcept
    from optuna_tpu_torch._lint.rules_sampler import (
        SMP001FallbackPolicySync,
        SMP002LadderCholeskyOnly,
    )
    from optuna_tpu_torch._lint.rules_storage import (
        ACT001ActionRegistrySync,
        CKPT001CheckpointEventSync,
        EXE001NonFinitePolicySync,
        FLT001FleetEventSync,
        FLT002LeaseEventSync,
        SRV001ShedPolicySync,
        STO001ReplayRegistrySync,
        STO002LockOrder,
    )

    return [
        TPU001HostSyncInJit(),
        TPU003DtypeDrift(),
        TPU004StrayDebugOutput(),
        OBS001TelemetryInTrace(),
        OBS002FlightEventSync(),
        OBS003DeviceStatSync(),
        OBS004HealthCheckSync(),
        OBS005SloRegistrySync(),
        STO001ReplayRegistrySync(),
        STO002LockOrder(),
        CONC001LockOrder(),
        CONC002BlockingUnderLock(),
        CONC003ThreadSharedWrite(),
        CONC004LocksanRegistrySync(),
        SRV001ShedPolicySync(),
        ACT001ActionRegistrySync(),
        FLT001FleetEventSync(),
        FLT002LeaseEventSync(),
        CKPT001CheckpointEventSync(),
        EXE001NonFinitePolicySync(),
        SMP001FallbackPolicySync(),
        SMP002LadderCholeskyOnly(),
        PY001BroadExcept(),
    ]
