"""Seconds from the process's start to the first timed trial: imports,
data, history, warm-up (host clock)."""


def read(run):
    return run.setup_s
