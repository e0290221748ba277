"""Hub-fleet lease records (the first names of
``optuna_tpu/storages/_grpc/fleet.py``).

A fleet of suggestion hubs over one storage keeps one ownership lease per
study, as a study system attr under :data:`LEASE_ATTR_PREFIX`; the study
doctor's ``service.hub_flapping`` / ``service.partition_suspected`` checks
read it through :func:`read_lease`. The keys and the record's shape are the
reference's, so either package's doctor reads the other's leases. The
router, the replicator, the leases' writers and the fleet client are the
rest of that module, and come with ROADMAP A9.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping

if TYPE_CHECKING:
    from optuna_tpu_torch.storages._base import BaseStorage

#: Study system-attr namespace of the per-study lease record:
#: ``lease:study:<study_id>``.
LEASE_ATTR_PREFIX = "lease:study:"


def lease_attr_key(study_id: int) -> str:
    return f"{LEASE_ATTR_PREFIX}{study_id}"


def read_lease(storage: "BaseStorage", study_id: int) -> dict | None:
    """The persisted lease record for a study (None when unleased).
    Shape: ``{"owner", "epoch", "ttl_s", "granted_unix", "renewed_unix",
    "history": [{"owner", "epoch", "unix"}, ...]}``."""
    lease = storage.get_study_system_attrs(study_id).get(lease_attr_key(study_id))
    return dict(lease) if isinstance(lease, Mapping) else None
