"""Where the time of the port's WFG hypervolume goes, on one CUDA card.

Run from the root of a checkout:

    python3 scripts/torch_wfg_probe.py

1. The one-node WFG kernel (``wfg_limit_filter_kernel`` in
   ``optuna_tpu_torch/ops/kernels/csrc/wfg_limit_filter.cu``) and its plain
   version across frame sizes n (m = 5), timed as ``chip_smoke.py`` times
   them (CUDA-graph replay), with every row eligible, with 80 % eligible as
   in ``chip_smoke.py``, and with none eligible (the staging alone).
2. The stack kernel (``wfg_stack_kernel``, one launch per hypervolume) by
   front size: the first 16, 32, 64, 128 and 256 Pareto points of 4096
   ``RandomState(0)`` points in 5 objectives, mapped into the unit box.
   Kernel time (CUDA events around one call, median of 3), stack
   iterations, and microseconds per iteration.
3. One hypervolume of a 5-objective front of 64 points under
   ``torch.profiler`` (``chip_smoke.profiled``, which also writes the full
   table beside its own): wall time, device busy share and the top
   operators.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (graph_ms, cuda_ms, wfg_roots, profiled, gpu_line)

FRONT_SIZES = (16, 32, 64, 128, 256)


def node_kernel_scaling(device) -> None:
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


def probe_front(k: int) -> np.ndarray:
    from optuna_tpu_torch.hypervolume import _normalize_for_device
    from optuna_tpu_torch.hypervolume.wfg import _pareto_filter

    front = _pareto_filter(np.random.RandomState(0).uniform(0.0, 1.0, size=(4096, 5)))[:k]
    unit, _, _ = _normalize_for_device(front, np.ones(5))
    return unit


def stack_kernel_scaling(device) -> None:
    from optuna_tpu_torch.ops.kernels import wfg

    for k in FRONT_SIZES:
        roots = chip_smoke.wfg_roots(probe_front(k), device)
        _, nodes = wfg.wfg_stack(*roots)
        n_nodes = int(nodes[0])
        ms = chip_smoke.cuda_ms(lambda: wfg.wfg_stack(*roots), reps=3)
        print(
            f"wfg_stack front {k} (bucket {roots[0].shape[1]}, M=5): {ms:.3f} ms, {n_nodes} stack iterations, "
            f"{ms / n_nodes * 1e3:.3f} us per iteration"
        )


def profile_hypervolume() -> None:
    from optuna_tpu_torch.ops import wfg

    unit = chip_smoke.unit_front(64)
    wfg.hypervolume_wfg_nd(unit, np.ones(5))  # warm
    wfg.reset_stats()
    wall_ms, busy_ms, kernels = chip_smoke.profiled("wfg", lambda: wfg.hypervolume_wfg_nd(unit, np.ones(5)))
    nodes = wfg.STATS["nodes"]
    print(
        f"hypervolume M=5 front 64 under the profiler: {nodes} stack iterations, {wfg.STATS['syncs']} sync(s), "
        f"{kernels} kernels in all; {wall_ms / nodes * 1e3:.3f} us of wall and {busy_ms / nodes * 1e3:.3f} us "
        f"of device time per iteration"
    )


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this probe needs a CUDA card")
    from optuna_tpu_torch.ops.kernels import _nvcc

    _nvcc.build("wfg_limit_filter.cu")
    device = torch.device("cuda", 0)
    node_kernel_scaling(device)
    stack_kernel_scaling(device)
    profile_hypervolume()
    print(f"gpu: {chip_smoke.gpu_line()}")


if __name__ == "__main__":
    main()
