"""The serve tier (port of ``optuna_tpu/storages/_grpc``): the gRPC storage
proxy (:mod:`._service` wire, :mod:`.server`, :mod:`.client`), the
suggestion service with its thin clients (:mod:`.suggest_service`) and the
hub fleet (:mod:`.fleet`). Only :mod:`.client` and the listener half of
:mod:`.server` need ``grpc``, and they import it when called.
"""

from optuna_tpu_torch.storages._grpc.client import GrpcStorageProxy
from optuna_tpu_torch.storages._grpc.server import run_grpc_proxy_server
from optuna_tpu_torch.storages._grpc.suggest_service import (
    ShedPolicy,
    SuggestService,
    ThinClientSampler,
)

__all__ = [
    "GrpcStorageProxy",
    "ShedPolicy",
    "SuggestService",
    "ThinClientSampler",
    "run_grpc_proxy_server",
]
