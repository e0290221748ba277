"""Share of the card's idle time in the traced window during which no range
of the program (``optuna_tpu_torch.*``) is open: the idle time that the
program's spans cannot explain. Each idle gap is split by its overlap in
time with the union of the program's ranges, not charged whole to the range
open at its start."""

from bench_port.trace import union

PREFIX = "optuna_tpu_torch."


def read(run):
    t = run.trace
    if t is None:
        return None
    gaps = t.idle_gaps()
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    spans = union([(r.start, r.end) for r in t.ranges if r.name.startswith(PREFIX)])
    covered, j = 0.0, 0
    for gs, ge in gaps:
        while j < len(spans) and spans[j][1] <= gs:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < ge:
            covered += min(ge, spans[k][1]) - max(gs, spans[k][0])
            k += 1
    return 100.0 * (idle - covered) / idle
