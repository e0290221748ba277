"""The gRPC tier's storage-side records (port of ``optuna_tpu/storages/_grpc``).

Only the lease record readers of :mod:`.fleet` are here, which the study
doctor reads; the proxy server, its client and the suggestion hubs come
with ROADMAP A9, and a ``grpc://`` storage URL still raises.
"""
