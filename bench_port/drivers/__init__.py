"""Drivers: one module a kind of traffic, named by a traffic mix's
``driver`` key. Each defines ``Cell``; see :mod:`bench_port.harness`."""
