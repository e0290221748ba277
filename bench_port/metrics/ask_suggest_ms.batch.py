"""Milliseconds a batch spends in the executor's ``ask.suggest`` span: the
per-trial suggestion loop, every trial's parameters written (telemetry).
None where the program records no such span."""


def read(run):
    h = (run.telemetry or {}).get("histograms", {}).get("phase.ask.suggest")
    return 1e3 * h["sum"] / h["count"] if h and h["count"] else None
