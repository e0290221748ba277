"""The controls on the card, on the trials and asks of a short window at the
cell's own size: config #5's reference trained with TF32 products, put in
the trainer's place, fails the limits of the losses' median and 85th
percentile, and uniform draws put in TPE's place fail the ask's limit;
the program on the same trials and asks passes them. ``calibrate.py``
reads the same numbers over a dozen seeds."""

from __future__ import annotations

import pytest

from bench_port import harness


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5_000_000_011, 5_000_000_012, 5_000_000_013])
def test_controls_fail_the_limits(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from bench_port.drivers import batch_study

    _, config, traffic = harness.resolve(harness.load_manifest(), "mlp_mnist.b256")
    cell = batch_study.Cell(config, traffic, seed, torch.device("cuda"))
    cell.setup()
    cell.run_window(10.0, harness.WindowClock())
    cell.release()
    r = batch_study.readings(cell._judged, cell.x, cell.labels, cell.base, int(config["sgd_steps"]), control=True)
    r.update(batch_study.ask_readings(cell._asks, config, cell.batch, seed, cell.device, control=True))
    limits = config["limits"]
    for name in ("loss_err_q50_ratio", "loss_err_q85_ratio", "ask_ks"):
        assert r[name] <= limits[name] < r["control_" + name], (name, r)
