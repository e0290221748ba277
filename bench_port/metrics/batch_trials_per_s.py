"""COMPLETE batched trials over the seconds of the measured window (host
clock), study restarts included."""


def read(run):
    n = run.counts.get("batch_trials")
    return n / run.window_s if n and run.window_s > 0 else None
