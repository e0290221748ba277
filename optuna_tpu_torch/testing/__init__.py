"""Shipped reusable test library (port of ``optuna_tpu/testing``): the
storage and sampler contract suites, the storage-mode matrix, the fake
DB-API and Redis, the fault kit they need, and the network chaos of the
serve tier (:mod:`.netchaos`)."""
