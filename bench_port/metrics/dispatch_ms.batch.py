"""Milliseconds a batch spends in the executor's ``dispatch`` span: the
upload, the batched trainer and the read of its losses (telemetry)."""


def read(run):
    d = (run.telemetry or {}).get("histograms", {}).get("phase.dispatch")
    return 1e3 * d["sum"] / d["count"] if d and d["count"] else None
