"""Share of the traced window in which no device operation ran (the union
of the profiler's device intervals), in a batched-trials cell."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None and t.window_s > 0 else None
