# graphlint fixture: output routed through a logger (no TPU004).
import logging

_logger = logging.getLogger(__name__)


def quiet(x):
    _logger.debug("value %s", x)
    printed = "print"  # a string, not a call
    return x, printed
