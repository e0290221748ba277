"""Milliseconds a batch spends in the executor's ``ask.create`` span: the
batch's trial creation, ``study.ask_batch`` (telemetry). None where the
program records no such span."""


def read(run):
    h = (run.telemetry or {}).get("histograms", {}).get("phase.ask.create")
    return 1e3 * h["sum"] / h["count"] if h and h["count"] else None
