"""Milliseconds a batch's dispatch spends in the ``dispatch.wait`` span: the
host blocked in the one read of the losses, waiting for the card
(telemetry). Divided by the ``dispatch`` count; None where the program
records no such span."""


def read(run):
    h = (run.telemetry or {}).get("histograms", {})
    wait, dispatch = h.get("phase.dispatch.wait"), h.get("phase.dispatch")
    return 1e3 * wait["sum"] / dispatch["count"] if wait and dispatch and dispatch["count"] else None
