"""The batched trainer's share of its roofline: the least time the card
could take for the window's trials (the larger of their shape-counted
float32 FLOPs over the card's float32 peak and their bytes over its memory
bandwidth) over the device time of the operations launched inside the
executor's ``dispatch`` ranges."""

from bench_port.costs import mlp


def read(run):
    n = run.counts.get("batch_trials")
    if run.trace is None or not n or not run.peaks:
        return None
    device_s = run.trace.device_s_under("dispatch")
    if not device_s:
        return None
    batch = int(run.traffic["batch_size"])
    flops = n * mlp.train_flops(run.config)
    bytes_ = (n / batch) * mlp.batch_bytes(run.config, batch)
    least = max(flops / run.peaks["f32_flops_per_s"], bytes_ / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / device_s
