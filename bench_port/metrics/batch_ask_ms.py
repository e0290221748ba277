"""Milliseconds a batch spends in the executor's ``ask`` phase: the batch
creation and the TPE batch ask (telemetry)."""


def read(run):
    ask = (run.telemetry or {}).get("histograms", {}).get("phase.ask")
    return 1e3 * ask["sum"] / ask["count"] if ask and ask["count"] else None
