"""Milliseconds a batch spends in TPE's ``ask.fit`` span: the history read
and split, the packing and the upload (telemetry). Divided by the ``ask``
count, since a study's start-up batch fits nothing; None where the program
records no such span."""


def read(run):
    h = (run.telemetry or {}).get("histograms", {})
    fit, ask = h.get("phase.ask.fit"), h.get("phase.ask")
    return 1e3 * fit["sum"] / ask["count"] if fit and ask and ask["count"] else None
