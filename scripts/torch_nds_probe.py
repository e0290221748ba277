"""Where the time of the port's non-domination ranking goes, on one CUDA card.

Run from the root of a checkout:

    python3 scripts/torch_nds_probe.py

For N in 256, 512, 1024, 4096 and 16384 rows of two objectives:

1. Random fronts: ``RandomState(N)`` uniform points, ordinal-transformed and
   padded as ``non_domination_rank_np`` does. The ranking kernels
   (``rank_fronts`` in ``optuna_tpu_torch/ops/kernels/nds.py``; device time
   from CUDA-graph replay, as ``chip_smoke.py`` times kernels), the plain
   peeling loop on the card (CUDA events around one call, host syncs
   inside), the host-clock time of the whole ``non_domination_rank_np``
   call (upload, kernels, read-back; best of 5), the number of fronts, the
   ranking launches per call, and whether the packed matrix sat in shared
   or global memory.
2. Chains of N fronts (every row dominates the rows after it), in row
   order, reversed, and shuffled: the kernels' device time and time per
   front; the plain loop too where it runs in seconds (N <= 4096).

Then one ranking of 512 rows under ``torch.profiler``: the kernels it ran.

    python3 scripts/torch_nds_probe.py --compare OTHER.cu

instead times the tree's ranking kernels against those built from OTHER.cu
(another revision of ``csrc/dominance.cu``, with the same C interface) on
the same inputs, in turns (tree, other, other, tree; device time from
CUDA-graph replay), at the random and chain inputs above, and checks that
both give the same ranks.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (graph_ms, cuda_ms, device_kernels, gpu_line, fail)

SIZES = (256, 512, 1024, 4096, 16384)
PLAIN_CHAIN_MAX = 4096


def padded_ordinals(values: np.ndarray, device):
    """``(values, mask)`` on ``device`` as ``non_domination_rank_np`` builds them."""
    import torch

    from optuna_tpu_torch.ops.kernels.nds import TILE

    n, m = values.shape
    ordinals = np.empty((n, m), np.float32)
    for j in range(m):
        ordinals[:, j] = np.unique(values[:, j], return_inverse=True)[1].reshape(-1)
    n_pad = -(-n // TILE) * TILE
    vp = np.full((n_pad, m), np.float32(n_pad + 1), np.float32)
    vp[:n] = ordinals
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    return torch.as_tensor(vp, device=device), torch.as_tensor(mask, device=device)


def chain(n: int, order: str, device):
    import torch

    depth = np.arange(n, dtype=np.float32)
    if order == "reversed":
        depth = depth[::-1].copy()
    elif order == "shuffled":
        depth = np.random.default_rng(n).permutation(n).astype(np.float32)
    return torch.as_tensor(np.stack([depth, depth], axis=1), device=device), torch.ones(n, device=device)


def check(v, mask, plain: bool) -> tuple[int, float | None]:
    """Fronts of one ranking, checked against the plain loop when ``plain``,
    and the plain loop's time (ms) then."""
    import torch

    from optuna_tpu_torch.ops.kernels import nds

    out = nds.rank_fronts(v, mask)
    torch.cuda.synchronize()
    if not plain:
        return int(out[-1]), None
    if not torch.equal(out, nds.rank_fronts_plain(v, mask)):
        chip_smoke.fail(f"rank_fronts at {tuple(v.shape)} differs from the plain peeling loop")
    return int(out[-1]), chip_smoke.cuda_ms(lambda: nds.rank_fronts_plain(v, mask), reps=3)


def random_fronts(device) -> None:
    import torch

    from optuna_tpu_torch.ops.kernels import nds
    from optuna_tpu_torch.ops.pareto import non_domination_rank_np

    for n in SIZES:
        values = np.random.RandomState(n).uniform(0, 1, size=(n, 2))
        v, mask = padded_ordinals(values, device)
        fronts, plain_ms = check(v, mask, plain=True)
        ms = chip_smoke.graph_ms(lambda: nds.rank_fronts(v, mask))
        before = nds.RANK_LAUNCHES
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            non_domination_rank_np(values)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        per_call = (nds.RANK_LAUNCHES - before) / 5
        route = "shared" if nds.ranks_in_shared(v.shape[0], device) else "global"
        print(
            f"rank random N={n} (m=2): {fronts} fronts; kernels {ms:.5f} ms device ({ms / fronts * 1e3:.3f} us a "
            f"front), plain loop {plain_ms:.3f} ms; non_domination_rank_np {min(host):.3f} ms host clock (best of "
            f"5); {per_call:.0f} ranking launch(es) a call (2 kernels each); matrix in {route} memory"
        )


def chains(device) -> None:
    from optuna_tpu_torch.ops.kernels import nds

    for n in SIZES:
        cells = []
        for order in ("in row order", "reversed", "shuffled"):
            v, mask = chain(n, order.split()[-1], device)
            fronts, plain_ms = check(v, mask, plain=n <= PLAIN_CHAIN_MAX)
            ms = chip_smoke.graph_ms(lambda: nds.rank_fronts(v, mask), per_graph=5, reps=5)
            plain = f"plain {plain_ms:.1f} ms" if plain_ms is not None else "plain not run"
            cells.append(f"{order}: {fronts} fronts, {ms:.4f} ms ({ms / fronts * 1e3:.3f} us a front), {plain}")
        print(f"rank chain N={n} (m=2): " + "; ".join(cells))


def compare(path: str, device) -> None:
    import torch

    from optuna_tpu_torch.ops.kernels import _nvcc, nds

    other = _nvcc.load(os.path.abspath(path), nds.bind)
    cases = [(f"random N={n}", padded_ordinals(np.random.RandomState(n).uniform(0, 1, size=(n, 2)), device))
             for n in SIZES]
    cases += [(f"chain N={n} {order}", chain(n, order, device)) for n in SIZES[:-1] for order in ("row", "shuffled")]
    for label, (v, mask) in cases:
        tree = lambda: nds.rank_fronts(v, mask)  # noqa: E731
        alt = lambda: nds._rank_launch(v, mask, lib=other)  # noqa: E731
        if not torch.equal(tree(), alt()):
            chip_smoke.fail(f"{label}: {path} ranks differently from the tree")
        reps = 5 if v.shape[0] > 1024 else 20
        t = [chip_smoke.graph_ms(fn, per_graph=reps, reps=reps) for fn in (tree, alt, alt, tree)]
        print(
            f"compare {label}: {int(tree()[-1])} fronts; tree {t[0]:.5f} / {t[3]:.5f} ms, "
            f"{os.path.basename(path)} {t[1]:.5f} / {t[2]:.5f} ms (device time, CUDA graph)"
        )


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this probe needs a CUDA card")
    from optuna_tpu_torch.ops.kernels import _nvcc, nds

    _nvcc.build("dominance.cu")
    device = torch.device("cuda", 0)
    if "--compare" in sys.argv:
        compare(sys.argv[sys.argv.index("--compare") + 1], device)
        print(f"gpu: {chip_smoke.gpu_line()}")
        return
    random_fronts(device)
    chains(device)
    v, mask = padded_ordinals(np.random.RandomState(512).uniform(0, 1, size=(512, 2)), device)
    print(f"rank N=512 under the profiler: {chip_smoke.device_kernels(lambda: nds.rank_fronts(v, mask))} kernel(s)")
    print(f"gpu: {chip_smoke.gpu_line()}")


if __name__ == "__main__":
    main()
