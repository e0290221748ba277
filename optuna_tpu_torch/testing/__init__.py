"""Shipped reusable test library (port of ``optuna_tpu/testing``): the
storage and sampler contract suites and the fault kit they need. The
storage-mode matrix, the fake DB-API and Redis, and the network chaos
wait for ROADMAP A8 and A9."""
