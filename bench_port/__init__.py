"""The benchmark of ``optuna_tpu_torch``: one run of one cell a process.

See ``bench_port/README.md`` for how to run a cell and how to add a
configuration, a traffic mix or a metric.
"""
