"""The whole batch step's share of the card's float32 peak: the
shape-counted FLOPs of the trials completed in the traced window over the
window's seconds times the peak."""

from bench_port.costs import mlp


def read(run):
    n = run.counts.get("batch_trials")
    if run.trace is None or not n or not run.peaks:
        return None
    return 100.0 * n * mlp.train_flops(run.config) / (run.trace.window_s * run.peaks["f32_flops_per_s"])
