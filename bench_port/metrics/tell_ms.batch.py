"""Milliseconds a batch spends in the executor's ``tell`` span: the batch's
tells and the callbacks they fire (telemetry)."""


def read(run):
    h = (run.telemetry or {}).get("histograms", {}).get("phase.tell")
    return 1e3 * h["sum"] / h["count"] if h and h["count"] else None
