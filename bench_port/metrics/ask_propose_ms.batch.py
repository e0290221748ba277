"""Milliseconds a batch spends in TPE's ``ask.propose`` span: the draws, the
scoring, the one read and the decode (telemetry). Divided by the ``ask``
count, since a study's start-up batch proposes nothing; None where the
program records no such span."""


def read(run):
    h = (run.telemetry or {}).get("histograms", {})
    propose, ask = h.get("phase.ask.propose"), h.get("phase.ask")
    return 1e3 * propose["sum"] / ask["count"] if propose and ask and ask["count"] else None
