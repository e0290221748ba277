# graphlint fixture: observability taps inside a registered device program
# (OBS001). The config registers chunk_program.
import logging as logging_module

from optuna_tpu_torch import device_stats, flight, telemetry

logger = logging_module.getLogger(__name__)


def chunk_program(x):
    telemetry.count("scan.rank1_updates")  # EXPECT: OBS001
    with flight.span("scan.chunk"):  # EXPECT: OBS001
        y = x * 2
    logger.warning("chunk ran")  # EXPECT: OBS001
    stats = device_stats.harvest({"scan.chunk_fill": y.sum()})  # EXPECT: OBS001
    return y, stats
