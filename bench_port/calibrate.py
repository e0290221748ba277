#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, a short
window of the cell as a run makes it, its judged answers' numbers (the
lower readings), and the same numbers for the controls on the same trials
and asks, in one process: the reference trained in float32 with TF32
products put in the trainer's place, and uniform draws put in TPE's.

    python3 bench_port/calibrate.py --workload mlp_mnist.b256 --seeds 1,2,3 --seconds 10

Prints one JSON line a seed and a summary line: the largest program
reading and the smallest control reading of each number. Needs a card.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402


def batch_readings(cell, seed: int) -> dict:
    from bench_port.drivers import batch_study

    r = batch_study.readings(cell._judged, cell.x, cell.labels, cell.base, int(cell.config["sgd_steps"]), control=True)
    r.update(batch_study.ask_readings(cell._asks, cell.config, cell.batch, seed, cell.device, control=True))
    r["failed_trials"] = float(cell.failed)
    return r


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args()
    manifest = harness.load_manifest()
    _, config, traffic = harness.resolve(manifest, args.workload)
    harness.configure_environment(config)
    import torch

    if not torch.cuda.is_available():
        harness.log("calibration needs a CUDA card")
        return 3
    torch.set_num_threads(int(config["host_threads"]))
    harness.log(f"card: {harness.power_line()}")
    driver = harness.load_driver(traffic)
    lows: dict[str, float] = {}
    highs: dict[str, float] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        cell = driver.Cell(config, traffic, seed, torch.device("cuda"))
        cell.setup()
        clock = harness.WindowClock()
        cell.run_window(args.seconds, clock)
        cell.release()
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        r = batch_readings(cell, seed)
        r["check_s"] = time.monotonic() - t1
        for k, v in r.items():
            if k.startswith("worst_trial") or k == "asks_judged":
                continue
            if k.startswith("control_"):
                highs[k] = min(highs.get(k, math.inf), v)
            elif not k.endswith("_s"):
                lows[k] = max(lows.get(k, -math.inf), v)
        r.update(seed=seed, window_s=clock.elapsed, counts=cell.counts, seconds=time.monotonic() - t0)
        print(json.dumps(r), flush=True)
        del cell
        torch.cuda.empty_cache()
    print(json.dumps({"largest_program_reading": lows, "smallest_control_reading": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
