"""Where the time of the port's WFG hypervolume goes, on one CUDA card.

Run from the root of a checkout:

    python3 scripts/torch_wfg_probe.py

1. The WFG node kernel (``optuna_tpu_torch/ops/kernels/csrc/wfg_limit_filter.cu``)
   and its plain version across frame sizes n (m = 5), timed as
   ``chip_smoke.py`` times them (CUDA-graph replay), with every row
   eligible, with 80 % eligible as in ``chip_smoke.py``, and with none
   eligible (the staging alone).
2. One hypervolume of a 5-objective front of 64 points under
   ``torch.profiler`` (``chip_smoke.profiled``, which also writes the full
   table beside its own): wall time, device busy share, kernels per stack
   iteration and the top operators.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (graph_ms, gpu_line)


def kernel_scaling(device) -> None:
    import torch

    from optuna_tpu_torch.ops.kernels import wfg

    m = 5
    for n in (16, 32, 64, 128, 256, 512, 1024):
        rng = np.random.RandomState(n)
        pts = torch.as_tensor(rng.uniform(0, 1, size=(n, m)).astype(np.float32), device=device)
        p = torch.as_tensor(rng.uniform(0, 0.6, size=m).astype(np.float32), device=device)
        ref = torch.full((m,), 1.5, device=device)
        cells = []
        for label, share in (("all", 1.0), ("80%", 0.8), ("none", 0.0)):
            elig = torch.as_tensor(rng.uniform(size=n) < share, device=device)
            ms = chip_smoke.graph_ms(lambda: wfg.limit_and_filter(pts, p, elig, ref))
            plain_ms = chip_smoke.graph_ms(lambda: wfg.limit_and_filter_plain(pts, p, elig, ref))
            cells.append(f"{label} eligible: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms")
        print(f"wfg_limit_filter n={n}, m={m}: " + "; ".join(cells))


def profile_hypervolume() -> None:
    from optuna_tpu_torch.hypervolume.wfg import _pareto_filter
    from optuna_tpu_torch.ops import wfg

    front = _pareto_filter(np.random.RandomState(0).uniform(0.0, 1.0, size=(512, 5)))[:64]
    lo = front.min(axis=0)
    unit = (front - lo) / (1.0 - lo)
    wfg.hypervolume_wfg_nd(unit, np.ones(5))  # warm
    wfg.reset_stats()
    wall_ms, _, kernels = chip_smoke.profiled("wfg", lambda: wfg.hypervolume_wfg_nd(unit, np.ones(5)))
    bodies = wfg.STATS["bodies"]
    print(
        f"hypervolume M=5 front 64 under the profiler: {wfg.STATS['nodes']} stack iterations, "
        f"{bodies} bodies, {wfg.STATS['syncs']} syncs; {kernels / bodies:.1f} kernels and "
        f"{wall_ms / bodies * 1e3:.1f} us of wall time per body"
    )


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this probe needs a CUDA card")
    from optuna_tpu_torch.ops.kernels import _nvcc

    _nvcc.build("wfg_limit_filter.cu")
    device = torch.device("cuda", 0)
    kernel_scaling(device)
    profile_hypervolume()
    print(f"gpu: {chip_smoke.gpu_line()}")


if __name__ == "__main__":
    main()
