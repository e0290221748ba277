#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line of
standard output.

    python3 bench_port/run.py --workload mlp_mnist.b256 --seed 7 --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` turns on
the package's telemetry and the profiler, and reports its per-layer metrics
with the device's busy time and a breakdown.
Every run checks what its window produced against the plain reference
(``correct``). Exits 3, printing no result, without as many CUDA cards as
the cell asks for, and 4 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import harness, isolation  # noqa: E402


def _finite(obj):
    """The result with non-finite numbers as strings, so the line is JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    t_start = harness.process_start(_T_IMPORT)

    try:
        manifest = harness.load_manifest()
        cell, config, _ = harness.resolve(manifest, args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as err:
        harness.log(f"cannot resolve {args.workload!r}: {err!r}")
        return 2
    harness.configure_environment(config)
    import importlib.util

    if importlib.util.find_spec("optuna_tpu_torch") is None:
        harness.log("the measured package optuna_tpu_torch is not in this checkout")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        harness.log(
            f"{args.workload} needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
        )
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = isolation.forbidden_modules(sys.modules)
    if found:
        harness.log(f"forbidden modules were loaded: {found}")
        return 4
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
