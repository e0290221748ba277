"""Shipped reusable test library (port of ``optuna_tpu/testing``): the
storage and sampler contract suites, the storage-mode matrix, the fake
DB-API and Redis, and the fault kit they need. The network chaos waits for
ROADMAP A9."""
