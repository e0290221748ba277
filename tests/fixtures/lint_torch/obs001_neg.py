# graphlint fixture: the same taps recorded around the device program, not
# inside it (no OBS001).
import logging as logging_module

from optuna_tpu_torch import device_stats, flight, telemetry

logger = logging_module.getLogger(__name__)


def chunk_program(x):
    return x * 2, {"scan.chunk_fill": x.sum()}


def run_chunk(x):
    with flight.span("scan.chunk"):
        y, stats = chunk_program(x)
    telemetry.count("scan.rank1_updates")
    logger.warning("chunk ran")
    device_stats.harvest(stats)
    return y
