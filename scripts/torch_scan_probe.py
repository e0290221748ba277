"""The scan loop (``optimize_scan``) on one CUDA card: the parts of a step
timed one by one, and optionally its chip phases alone, traced.

Run from the root of a checkout:

    python3 scripts/torch_scan_probe.py            # the parts of a step
    python3 scripts/torch_scan_probe.py --phases   # also the scan phases

Builds K1, then, on the sparse phase's shapes (m = 256, n = 4096, d = 20),
times the pieces of a step by host clock, each ending in a sync (median of
5 warm calls), with the kernels each runs (profiler): the rank-1 raise of a
sparse tell (``ladder_cholesky_rank1_raise``, the ``dchud`` sweep), one
``sparse_tell``, one ``sgpr_reduce`` (a swap-in), and the exact chunk's row
append at n = 1024 (``ladder_cholesky_rank1_update``). Then it runs one
chunk of 32 of each engine (exact at bucket 1024, SGPR at bucket 4096) with
``torch.cuda.set_sync_debug_mode("warn")`` and prints where the host waits
on the card: each synchronizing call's line in the port, per step. With ``--phases`` it
first runs ``chip_smoke.py``'s scan phases (the card-against-CPU chunk; the
fresh twin; the exact chunks at bucket 1024 and the SGPR chunks at bucket
4096, m_pad 256, each followed by one more chunk under ``torch.profiler``:
kernels and host reads per step).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402  (the scan phases, device_kernels, gpu_line, fail)


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``reps`` warm calls, each ending in a sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def step_parts(device) -> None:
    import torch

    from optuna_tpu_torch.gp.gp import _JITTER, GPParams, _kernel_with_noise, matern52
    from optuna_tpu_torch.gp.sparse import sgpr_reduce, sparse_tell
    from optuna_tpu_torch.samplers._resilience import (
        ladder_cholesky_rank1_raise,
        ladder_cholesky_rank1_update,
        ladder_cholesky_with_rung,
    )

    rng = np.random.default_rng(0)
    m, n, d = 256, 4096, 20
    to = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    X = to(rng.uniform(size=(n, d)))
    y = to(rng.standard_normal(n))
    mask = torch.ones(n, device=device)
    Z, zy, zm = X[:m].clone(), y[:m].clone(), torch.ones(m, device=device)
    cat = torch.zeros(d, dtype=torch.bool, device=device)
    params = GPParams(to(np.full(d, 0.5)), to(1.0), to(1e-3))
    state, Lmm, L_B, b, _ = sgpr_reduce(params, Z, zy, zm, X, y, mask, cat)
    x_new = to(rng.uniform(size=d))
    u = torch.linalg.solve_triangular(Lmm, matern52(x_new[None], Z, params, cat)[0][:, None], upper=False)[:, 0]
    parts = {
        f"rank-1 raise (dchud), m={m}": lambda: ladder_cholesky_rank1_raise(L_B, u, lambda: L_B @ L_B.T),
        f"sparse_tell, m={m}": lambda: sparse_tell(state, Lmm, L_B, b, x_new, y[0], cat),
        f"sgpr_reduce (a swap-in), ({m}, {n}, {d})": lambda: sgpr_reduce(params, Z, zy, zm, X, y, mask, cat),
    }
    N = 1024
    Xe, ye = X[:N].clone(), y[:N].clone()
    me = (torch.arange(N, device=device) < N - 1).to(torch.float32)
    L, _ = ladder_cholesky_with_rung(_kernel_with_noise(Xe, params, cat, me))
    k_row = torch.where(
        torch.arange(N, device=device) == N - 1,
        params.scale + params.noise + _JITTER,
        matern52(Xe[N - 1][None], Xe, params, cat)[0],
    )
    parts[f"row append (exact tell), n={N}"] = lambda: ladder_cholesky_rank1_update(
        L, k_row, N - 1, lambda: _kernel_with_noise(Xe, params, cat, torch.ones(N, device=device))
    )
    for label, fn in parts.items():
        print(f"scan step part {label}: {host_ms(fn):.3f} ms host clock, {chip_smoke.device_kernels(fn, calls=3)} kernels")


def sync_sites(label: str, n_history: int, chunk_len: int, **kwargs) -> None:
    """One chunk (its fit and sync included) on a new seeded study, with every
    synchronizing CUDA call reported: the count per step of each calling
    line inside the repo."""
    import warnings

    import torch

    from optuna_tpu_torch.parallel import optimize_scan

    study, objective = chip_smoke.seeded_study(n_history), chip_smoke.scan_objective()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            optimize_scan(study, objective, chunk_len, sync_every=chunk_len, seed=1, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites: dict[str, int] = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    total = sum(sites.values())
    top = sorted(sites.items(), key=lambda kv: -kv[1])[:12]
    print(
        f"sync sites {label}: {total / chunk_len:.1f} synchronizing calls a step (a chunk of {chunk_len}, its fit "
        "and sync included); per step by line: " + "; ".join(f"{k} {v / chunk_len:.2f}" for k, v in top)
    )


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this probe needs a CUDA card")
    import optuna_tpu_torch
    from optuna_tpu_torch.ops.kernels import matern

    optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
    print("gpu:", chip_smoke.gpu_line())
    device = torch.device("cuda", 0)
    chip_smoke.phase_build()
    if "--phases" in sys.argv[1:]:
        t0 = time.perf_counter()
        chip_smoke.phase_scan_chunk(device)
        k1 = lambda: matern.LAUNCHES  # noqa: E731
        chip_smoke.phase_scan_fresh(k1)
        chip_smoke.phase_scan_exact(k1, profile=True)
        chip_smoke.phase_scan_sparse(k1, profile=True)
        print(f"scan phases: {time.perf_counter() - t0:.1f} s")
    step_parts(device)
    sync_sites("exact, bucket 1024", 960, 32)
    sync_sites("sparse, bucket 4096, m 256", 4000, 32, n_exact_max=1024, n_inducing=256)


if __name__ == "__main__":
    main()
