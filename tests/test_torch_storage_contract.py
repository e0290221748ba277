"""The port's storage contract (``optuna_tpu_torch/testing/pytest_storages.py``)
over every ported storage mode, as ``tests/test_storage_contract.py`` runs
the reference's: plainly, and with every call passing through
``FaultInjectorStorage`` (5 % transient faults) and ``RetryingStorage``.

The modes are ``optuna_tpu_torch.testing.storages.STORAGE_MODES``: in
memory, sqlite, cached sqlite, the journal file, the fake-Redis journal,
the PostgreSQL dialect over the fake DB-API, and the port's gRPC proxy on a
loopback port over sqlite and over a journal file: the reference's modes.
"""

from __future__ import annotations

import pytest

from optuna_tpu_torch.storages import RetryingStorage, RetryPolicy
from optuna_tpu_torch.testing.fault_injection import FaultInjectorStorage, FaultPlan
from optuna_tpu_torch.testing.pytest_storages import StorageTestCase
from optuna_tpu_torch.testing.storages import STORAGE_MODES, StorageSupplier


class TestStorageContract(StorageTestCase):
    @pytest.fixture(params=STORAGE_MODES)
    def storage(self, request):
        with StorageSupplier(request.param) as s:
            yield s


# Aggregated across the whole under-faults matrix: one short test may draw
# zero faults at a 5 % rate, the matrix as a whole cannot.
_FAULTS = {"injected": 0, "fixture_runs": 0}


class TestStorageContractUnderFaults(StorageTestCase):
    @pytest.fixture(params=STORAGE_MODES)
    def storage(self, request):
        with StorageSupplier(request.param) as inner:
            injector = FaultInjectorStorage(
                inner,
                # Faults strike before the backend call executes, so retried
                # creates cannot double-apply (the seed varies by mode so the
                # matrix does not fault in lockstep).
                FaultPlan(transient_rate=0.05, seed=sum(map(ord, request.param))),
            )
            yield RetryingStorage(
                injector,
                RetryPolicy(max_attempts=25, deadline=None, sleep=lambda _s: None),
                retry_non_idempotent=True,
            )
            _FAULTS["injected"] += injector.faults_injected
            _FAULTS["fixture_runs"] += 1


def test_fault_matrix_actually_injected():
    """Runs after the class above (file order): the under-faults matrix must
    have injected real faults, or it degraded to a happy-path rerun."""
    if _FAULTS["fixture_runs"] < len(STORAGE_MODES):
        pytest.skip("under-faults matrix not (fully) selected in this run")
    assert _FAULTS["injected"] > 0


def test_modes_are_the_references_less_the_grpc_proxy():
    # The gRPC proxy is ported, so nothing is left out any more.
    from optuna_tpu.testing.storages import STORAGE_MODES as REF_MODES

    assert STORAGE_MODES == REF_MODES
