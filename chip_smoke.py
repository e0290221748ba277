"""Quickest proof that optuna_tpu_torch runs its main path on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # also trace one more ask of each engine

Phases (any failure exits non-zero and prints no result line):

1. Build every CUDA kernel of the paths from ``optuna_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card at its
   path's shapes, and time it, its plain version and its bound: the Matérn
   Gram (K1) also against a float64 oracle, at ragged and categorical shapes;
   the dominance matrix (K2) and the WFG node (K3) bit for bit.
3. A small sparse reduction on the card against the same code on the CPU.
4. Exact engine: a GPSampler study on Hartmann-20D with 1000 seeded completed
   trials, then 3 GP asks.
5. Sparse engine: the same with 4000 trials and 8 GP asks, each through the
   SGPR program and its CUDA Matérn Gram (m = 256, N bucket 4096).
6. NSGA-II on ZDT1 (30 variables, population 256, 1024 trials): generations
   2 and 3 rank 512 trials through the dominance kernel. The same study on
   the CPU must be identical trial for trial.
7. The 5-objective hypervolume of a 512-point front and the leave-one-out
   contributions of its first 64 points through the WFG stack machine and
   its node kernel, against the host float64 oracle and the CPU.
8. Host and card times at the reference's routing thresholds (rank at
   256/512/1024 points, WFG at fronts of 32 and 64).

The kernel launch counters are set to 0 just before each path (phases 4-5,
6, 7) and read just after it; every kernel must have launched on its path.
The line before the last is the kernel table as JSON; the last line is the
device summary.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# The kernels of the main path: wrapper module, source, TPU kernel replaced.
KERNELS = [
    {
        "name": "matern52_gram",
        "module": "optuna_tpu_torch.ops.kernels.matern",
        "source": "optuna_tpu_torch/ops/kernels/csrc/matern52_gram.cu",
        "replaces": "optuna_tpu/ops/pallas/matern.py:55",
    },
    {
        "name": "nds",
        "module": "optuna_tpu_torch.ops.kernels.nds",
        "source": "optuna_tpu_torch/ops/kernels/csrc/dominance.cu",
        "replaces": "optuna_tpu/ops/pallas/nds.py:24",
    },
    {
        "name": "wfg_limit_filter",
        "module": "optuna_tpu_torch.ops.kernels.wfg",
        "source": "optuna_tpu_torch/ops/kernels/csrc/wfg_limit_filter.cu",
        "replaces": "optuna_tpu/ops/pallas/wfg.py:40",
    },
]
KERNEL = {k["name"]: k for k in KERNELS}
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL_VS_PLAIN = 1e-6  # f32 kernel against the f32 plain version: summation order only
TOL_VS_F64 = 1e-6  # the reference's XLA twin is 2.2e-7 from f64 at (37, 23, 5)
SMALL_TOL = 2e-3  # card vs CPU on a small sparse reduction: Cholesky/triangular-solve order
HV_TOL_F64 = 1e-3  # f32 WFG stack vs the f64 host oracle at 512 points (tests/test_hypervolume.py)
HV_TOL_CPU = 1e-6  # the same stack on the card and the CPU: same f32 operations, same order
LOO_TOL = 2e-3  # leave-one-out vs the host oracle, as a share of the total (tests/test_hypervolume.py)
NSGA_POP, NSGA_TRIALS, ZDT_DIM = 256, 1024, 30
HV_REF_ZDT = (1.1, 10.0)  # bench.py's ZDT1 hypervolume reference point


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def graph_ms(fn, per_graph: int = 20, reps: int = 20) -> float:
    """Device time of one call: ``per_graph`` calls captured in a CUDA graph,
    the graph replayed ``reps`` times between CUDA events, the median divided
    by ``per_graph``. The host's per-call overhead is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return float(np.median(times))


def cuda_ms(fn, reps: int = 50) -> float:
    """Median of ``reps`` warm calls, each timed with CUDA events: the time a
    caller sees on the stream, host launch overhead included."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_build() -> float:
    from concurrent.futures import ThreadPoolExecutor

    from optuna_tpu_torch.ops.kernels import _nvcc

    t0 = time.perf_counter()
    sources = [os.path.basename(k["source"]) for k in KERNELS]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        paths = list(pool.map(_nvcc.build, sources))
    seconds = time.perf_counter() - t0
    for src, path in zip(sources, paths):
        print(f"build: {src} -> {os.path.relpath(path)}")
        for line in _nvcc.BUILD_LOGS.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {len(sources)} kernel(s) in {seconds:.3f} s")
    return seconds


def kernel_row(name: str, max_abs_err: float, ms: float, plain_ms: float, n_bytes: int, n_ops: int) -> dict:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": KERNEL[name]["source"],
        "replaces": KERNEL[name]["replaces"],
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def print_times(
    name: str, shape, fn, plain_fn, n_bytes: int, n_ops: int, max_abs_err: float, unit: str = "compares"
) -> dict:
    """Time a kernel and its plain version (device time from a CUDA graph,
    and per call with host overhead), print them beside the bound, and
    return the kernel's row of the table."""
    ms = graph_ms(fn)
    plain_ms = graph_ms(plain_fn)
    call_ms = cuda_ms(fn)
    plain_call_ms = cuda_ms(plain_fn)
    row = kernel_row(name, max_abs_err, ms, plain_ms, n_bytes, n_ops)
    print(
        f"{name} time at {shape}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms "
        f"(device time, CUDA graph); per call with host overhead: kernel {call_ms:.4f} ms, "
        f"plain {plain_call_ms:.4f} ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
        f"{n_bytes} B, {n_ops} {unit}); no single PyTorch call computes this function"
    )
    return row


def matern_inputs(n1, n2, d, n_cat, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 1, size=(n1, d)).astype(np.float32)
    x2 = rng.uniform(0, 1, size=(n2, d)).astype(np.float32)
    cat = np.zeros(d, dtype=bool)
    cat[d - n_cat:] = True
    if n_cat:
        x1[:, cat] = rng.integers(0, 3, size=(n1, n_cat))
        x2[:, cat] = rng.integers(0, 3, size=(n2, n_cat))
    w = rng.uniform(0.1, 3.0, size=d).astype(np.float32)
    scale = np.float32(rng.uniform(0.5, 2.0))
    to = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return to(x1), to(x2), to(w), to(scale), to(cat, torch.bool)


def phase_matern(device) -> dict:
    import torch

    from optuna_tpu_torch.ops.kernels import matern

    cases = [("main path Z x X", 256, 4096, 20, 0), ("ragged", 37, 23, 5, 0), ("categorical", 100, 300, 12, 4)]
    worst_plain = 0.0
    for label, n1, n2, d, n_cat in cases:
        args = matern_inputs(n1, n2, d, n_cat, seed=n1 + n2 + d, device=device)
        out = matern.matern52_gram(*args)
        torch.cuda.synchronize()
        plain = matern.matern52_gram_plain(*args)
        oracle = matern.matern52_gram_plain(*(a.double() if a.is_floating_point() else a for a in args))
        if out.shape != (n1, n2) or not bool(torch.isfinite(out).all()):
            fail(f"matern52_gram {label}: bad output shape or non-finite values")
        e_plain = float((out - plain).abs().max())
        e_f64 = float((out.double() - oracle).abs().max())
        e_plain_f64 = float((plain.double() - oracle).abs().max())
        print(
            f"matern52_gram {label} ({n1}, {n2}, {d}, cat={n_cat}): max|kernel-plain| = {e_plain:.3e}, "
            f"max|kernel-f64| = {e_f64:.3e}, max|plain-f64| = {e_plain_f64:.3e} "
            f"(tolerance {TOL_VS_PLAIN:.0e} / {TOL_VS_F64:.0e})"
        )
        if not (e_plain <= TOL_VS_PLAIN and e_f64 <= TOL_VS_F64):
            fail(f"matern52_gram {label} disagrees with its plain version or f64")
        worst_plain = max(worst_plain, e_plain)

    n1, n2, d = 256, 4096, 20
    args = matern_inputs(n1, n2, d, 0, seed=n1 + n2 + d, device=device)
    return print_times(
        "matern52_gram", (n1, n2, d), lambda: matern.matern52_gram(*args),
        lambda: matern.matern52_gram_plain(*args),
        n_bytes=4 * (n1 * d + n2 * d + d + 1 + n2 * n1) + d,  # inputs read once, output written once
        n_ops=n1 * n2 * (3 * d + 9),  # sub, mul, fma per dim; sqrt, exp and 7 flops per element
        max_abs_err=worst_plain, unit="flops",
    )


def nds_inputs(n: int, m: int, n_pad: int, seed: int, device):
    """Ordinals as ``non_domination_rank_np`` makes them: small integers with
    ties and duplicate rows, padded rows at ``n_pad + 1``."""
    import torch

    rng = np.random.default_rng(seed)
    v = rng.integers(0, max(2, n // 8), size=(n, m)).astype(np.float32)
    v[1::7] = v[0::7][: len(v[1::7])]
    out = np.full((n_pad, m), np.float32(n_pad + 1), np.float32)
    out[:n] = v
    return torch.as_tensor(out, device=device)


def phase_nds(device) -> dict:
    import torch

    from optuna_tpu_torch.ops.kernels import nds

    for label, n, m, n_pad in (("main path", 512, 2, 512), ("ties, duplicates, padding", 600, 5, 640), ("one tile", 128, 3, 128)):
        v = nds_inputs(n, m, n_pad, seed=n + m, device=device)
        out = nds.dominance_matrix(v)
        torch.cuda.synchronize()
        plain = nds.dominance_matrix_plain(v)
        same = torch.equal(out, plain)
        print(f"nds {label} ({n_pad}, {m}): bit-exact {same}, {int(plain.sum())} dominance pairs")
        if not same:
            fail(f"nds {label}: the kernel differs from its plain version")
    n, m = 512, 2
    v = nds_inputs(n, m, n, seed=n + m, device=device)
    return print_times(
        "nds", (n, m), lambda: nds.dominance_matrix(v), lambda: nds.dominance_matrix_plain(v),
        n_bytes=4 * (n * m + n * n), n_ops=2 * m * n * n, max_abs_err=0.0,
    )


def wfg_frame(n: int, m: int, seed: int, device):
    """A frame as tests/test_ops_pallas.py:129-137 makes one: random points,
    pivot and eligibility, reference point 1.5."""
    import torch

    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1, size=(n, m)).astype(np.float32)
    pts[1] = pts[0]
    p = rng.uniform(0, 0.6, size=m).astype(np.float32)
    eligible = rng.uniform(size=n) < 0.8
    ref = np.full(m, 1.5, np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (pts, p, eligible, ref))


def phase_wfg_kernel(device) -> dict:
    import torch

    from optuna_tpu_torch.ops.kernels import wfg

    for n, m in ((128, 5), (512, 5), (64, 6)):
        frame = wfg_frame(n, m, seed=n * m, device=device)
        out_pts, out_msk = wfg.limit_and_filter(*frame)
        torch.cuda.synchronize()
        plain_pts, plain_msk = wfg.limit_and_filter_plain(*frame)
        same = torch.equal(out_pts, plain_pts) and torch.equal(out_msk, plain_msk)
        print(f"wfg_limit_filter ({n}, {m}): bit-exact {same}, {int(plain_msk.sum())} rows kept")
        if not same:
            fail(f"wfg_limit_filter ({n}, {m}): the kernel differs from its plain version")
    n, m = 128, 5
    frame = wfg_frame(n, m, seed=n * m, device=device)
    return print_times(
        "wfg_limit_filter", (n, m), lambda: wfg.limit_and_filter(*frame), lambda: wfg.limit_and_filter_plain(*frame),
        n_bytes=4 * (2 * n * m + 2 * m) + 2 * n, n_ops=2 * m * n * n + n * m, max_abs_err=0.0,
    )


def nsga_summary(study):
    trials = [(t.number, t.state.name, t.params, t.values, t.system_attrs) for t in study.get_trials(deepcopy=False)]
    return trials, study._storage.get_study_system_attrs(study._study_id)


def run_nsga(device_arg) -> tuple:
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import zdt1
    from optuna_tpu_torch.samplers import NSGAIISampler

    kwargs = {} if device_arg is None else {"device": device_arg}
    study = ot.create_study(
        directions=["minimize", "minimize"], sampler=NSGAIISampler(seed=0, population_size=NSGA_POP, **kwargs)
    )
    t0 = time.perf_counter()
    study.optimize(lambda t: zdt1(t, dim=ZDT_DIM), n_trials=NSGA_TRIALS)
    torch.cuda.synchronize()
    return study, time.perf_counter() - t0


def phase_nsga() -> float:
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.hypervolume import compute_hypervolume

    card, card_s = run_nsga(None)
    cpu, cpu_s = run_nsga("cpu")
    complete = [t for t in card.get_trials(deepcopy=False) if t.state == ot.TrialState.COMPLETE]
    if len(complete) != NSGA_TRIALS:
        fail(f"NSGA-II: {len(complete)} COMPLETE trials, expected {NSGA_TRIALS}")
    if nsga_summary(card) != nsga_summary(cpu):
        fail("NSGA-II: the study on the card differs from the same study on the CPU")
    values = np.asarray([t.values for t in complete])
    if not np.isfinite(values).all():
        fail("NSGA-II: non-finite objective values")
    hv = compute_hypervolume(values, np.asarray(HV_REF_ZDT))
    print(
        f"NSGA-II ZDT1 (d={ZDT_DIM}, population {NSGA_POP}, {NSGA_TRIALS} trials): identical to the CPU run "
        f"trial for trial; card {card_s / NSGA_TRIALS * 1e3:.3f} ms/trial ({card_s:.2f} s), "
        f"CPU {cpu_s / NSGA_TRIALS * 1e3:.3f} ms/trial ({cpu_s:.2f} s); hypervolume at {HV_REF_ZDT}: {hv:.6f}"
    )
    return card_s


def host_loo(front: np.ndarray, ref: np.ndarray) -> np.ndarray:
    from optuna_tpu_torch.hypervolume.wfg import compute_hypervolume as host_hv

    total = host_hv(front, ref)
    return np.array([max(total - host_hv(np.delete(front, i, axis=0), ref), 0.0) for i in range(len(front))])


def phase_hv() -> float:
    import torch

    from optuna_tpu_torch.hypervolume import compute_hypervolume, loo_contributions
    from optuna_tpu_torch.hypervolume.wfg import _compute_hv_recursive, _pareto_filter
    from optuna_tpu_torch.ops import wfg

    front = np.random.RandomState(0).uniform(0.0, 1.0, size=(512, 5))
    ref = np.ones(5)
    runs = {}
    for label, dev in (("card", None), ("cpu", "cpu")):
        wfg.reset_stats()
        t0 = time.perf_counter()
        hv = compute_hypervolume(front, ref, device=dev)
        torch.cuda.synchronize()
        runs[label] = (hv, time.perf_counter() - t0, dict(wfg.STATS))
    t0 = time.perf_counter()
    pareto = _pareto_filter(front)
    oracle = _compute_hv_recursive(pareto, ref)
    oracle_s = time.perf_counter() - t0
    hv, card_s, stats = runs["card"]
    e_f64 = abs(hv - oracle) / oracle
    e_cpu = abs(hv - runs["cpu"][0]) / abs(runs["cpu"][0])
    print(
        f"hypervolume M=5, 512 points (front {len(pareto)}, bucket {wfg._pad_bucket(len(pareto))}): card {hv:.9f} "
        f"in {card_s:.3f} s ({stats['nodes']} stack iterations, {stats['bodies']} K3 launches, "
        f"{stats['syncs']} host syncs); CPU {runs['cpu'][0]:.9f} in {runs['cpu'][1]:.3f} s; "
        f"host f64 oracle {oracle:.9f} in {oracle_s:.3f} s; rel err vs f64 {e_f64:.3e} (tolerance {HV_TOL_F64}), "
        f"vs CPU {e_cpu:.3e} (tolerance {HV_TOL_CPU})"
    )
    if not (math.isfinite(hv) and e_f64 <= HV_TOL_F64 and e_cpu <= HV_TOL_CPU):
        fail("5-objective hypervolume disagrees with the f64 oracle or the CPU")

    sub = front[:64]
    t0 = time.perf_counter()
    want = host_loo(sub, ref)
    oracle_s = time.perf_counter() - t0
    if oracle_s > 60.0:
        print(f"host leave-one-out oracle took {oracle_s:.1f} s at 64 points: using the first 32")
        sub = front[:32]
        want = host_loo(sub, ref)
    wfg.reset_stats()
    t0 = time.perf_counter()
    got = loo_contributions(sub, ref)
    torch.cuda.synchronize()
    loo_s = time.perf_counter() - t0
    total = _compute_hv_recursive(_pareto_filter(sub), ref)
    err = float(np.max(np.abs(got - want))) / total
    print(
        f"leave-one-out M=5, {len(sub)} points: card {loo_s:.3f} s ({wfg.STATS['nodes']} stack iterations, "
        f"{wfg.STATS['bodies']} K3 launches, {wfg.STATS['syncs']} host syncs); host oracle {oracle_s:.3f} s; "
        f"max |card - oracle| / total {err:.3e} (tolerance {LOO_TOL}); {int(np.sum(got > 0))} positive"
    )
    if not (np.isfinite(got).all() and err <= LOO_TOL):
        fail("leave-one-out contributions disagree with the host oracle")
    return card_s + loo_s


def phase_thresholds() -> None:
    """Host and card times around the reference's TPU-measured routing
    thresholds. They are printed, not acted on."""
    import torch

    from optuna_tpu_torch.hypervolume.wfg import _compute_hv_recursive, _pareto_filter
    from optuna_tpu_torch.ops.pareto import non_domination_rank_np
    from optuna_tpu_torch.ops.wfg import hypervolume_wfg_nd
    from optuna_tpu_torch.study import _multi_objective

    def best_of(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times) * 1e3

    rng = np.random.RandomState(1)
    parts = []
    for n in (256, 512, 1024):
        values = rng.uniform(0, 1, size=(n, 2))
        saved = _multi_objective._DEVICE_RANK_MIN_POINTS
        _multi_objective._DEVICE_RANK_MIN_POINTS = n + 1  # force the host sort
        try:
            host_ms = best_of(lambda: _multi_objective._fast_non_domination_rank(values, n_below=n // 2))
        finally:
            _multi_objective._DEVICE_RANK_MIN_POINTS = saved
        card_ms = best_of(lambda: non_domination_rank_np(values))
        parts.append(f"rank n={n} (m=2, n_below=n/2): host {host_ms:.2f} ms, card {card_ms:.2f} ms")
    front = _pareto_filter(np.random.RandomState(0).uniform(0.0, 1.0, size=(512, 5)))
    for k in (32, 64):
        pts = front[:k]
        lo = pts.min(axis=0)
        unit = (pts - lo) / (1.0 - lo)
        host_ms = best_of(lambda: _compute_hv_recursive(pts, np.ones(5)), reps=1)
        card_ms = best_of(lambda: hypervolume_wfg_nd(unit, np.ones(5)), reps=1)
        parts.append(f"WFG M=5 front {k}: host {host_ms:.1f} ms, card {card_ms:.1f} ms")
    print("routing thresholds (TPU-measured, kept): " + "; ".join(parts))


def seeded_study(n_history: int, seed: int = 0):
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.distributions import FloatDistribution
    from optuna_tpu_torch.models.benchmarks import hartmann6_np
    from optuna_tpu_torch.samplers import GPSampler

    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n_history, 20))
    values = hartmann6_np(X)
    dists = {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(20)}
    study = ot.create_study(sampler=GPSampler(seed=seed))
    study.add_trials(
        ot.create_trial(params={f"x{i}": float(row[i]) for i in range(20)}, distributions=dists, value=float(v))
        for row, v in zip(X, values)
    )
    return study


def device_profile(prof) -> tuple[float, int, list, object]:
    """From a finished ``torch.profiler`` run: the device's busy ms and kernel
    count, summed over the device-side events only (an operator's row repeats
    its kernels' time, so summing every row counts each kernel twice), and
    the host-side operators sorted by the device time of their kernels."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))  # noqa: E731
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev(e) for e in on_device) / 1e3
    kernels = sum(e.count for e in on_device)
    ops = sorted((e for e in events if e.device_type != DeviceType.CUDA), key=dev, reverse=True)
    return busy_ms, kernels, ops, dev


def profiled(label: str, fn) -> tuple[float, float, int]:
    """Run ``fn`` under torch.profiler; print the device's busy share and the
    top operators, write the full table to chiprun_out/, and return the wall
    ms, the busy ms and the kernel count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels, ops, dev = device_profile(prof)
    print(
        f"profile {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {kernels} kernels; top: "
        + "; ".join(f"{e.key[:48]} x{e.count} {dev(e) / 1e3:.2f} ms" for e in ops[:8])
    )
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"profile_{label.replace(' ', '_')}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    return wall_ms, busy_ms, kernels


def run_asks(label: str, n_history: int, n_asks: int, profile: bool = False) -> list[float]:
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import hartmann20

    study = seeded_study(n_history)
    seconds = []
    for _ in range(n_asks):
        t0 = time.perf_counter()
        study.optimize(hartmann20, n_trials=1)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    if profile:  # one more, traced ask; the profiler's own cost stays out of `seconds`
        profiled(label, lambda: study.optimize(hartmann20, n_trials=1))
    n_expected = n_history + n_asks + int(profile)
    trials = study.get_trials(deepcopy=False)
    complete = [t for t in trials if t.state == ot.TrialState.COMPLETE]
    if len(complete) != n_expected:
        fail(f"{label}: {len(complete)} COMPLETE trials, expected {n_expected}")
    for t in complete[n_history:]:
        xs = [t.params[f"x{i}"] for i in range(20)]
        if not (math.isfinite(t.value) and all(0.0 <= x <= 1.0 for x in xs)):
            fail(f"{label}: trial {t.number} is non-finite or out of bounds")
    print(
        f"{label}: n={n_history}, {n_asks} GP asks, seconds per ask "
        f"{[round(s, 4) for s in seconds]}, median {float(np.median(seconds)):.4f} s, "
        f"best value {study.best_value:.6f}"
    )
    return seconds


def phase_small_sparse(device) -> None:
    """sgpr_reduce on the card (CUDA Gram) against the CPU (plain Gram)."""
    import torch

    from optuna_tpu_torch.gp.gp import GPParams
    from optuna_tpu_torch.gp.sparse import sgpr_reduce

    rng = np.random.default_rng(3)
    m, n, d = 16, 64, 5
    X = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-8:] = 0.0
    idx = rng.choice(n - 8, size=m, replace=False)
    w = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    results = {}
    for dev in (device, torch.device("cpu")):
        to = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        params = GPParams(to(w), to(np.float32(1.1)), to(np.float32(0.01)))
        state, _, _, _, rung = sgpr_reduce(
            params, to(X[idx]), to(y[idx]), to(np.ones(m)), to(X), to(y), to(mask), to(np.zeros(d), torch.bool)
        )
        results[dev.type] = (state.alpha.cpu().double(), state.L.cpu().double(), rung)
    a_gpu, l_gpu, r_gpu = results[device.type]
    a_cpu, l_cpu, r_cpu = results["cpu"]
    e_alpha = float((a_gpu - a_cpu).abs().max() / a_cpu.abs().max())
    e_l = float((l_gpu - l_cpu).abs().max() / l_cpu.abs().max())
    print(f"small sgpr_reduce card vs CPU: rel err alpha {e_alpha:.3e}, L {e_l:.3e}, rungs {r_gpu}/{r_cpu} (tolerance {SMALL_TOL})")
    if not (e_alpha <= SMALL_TOL and e_l <= SMALL_TOL and r_gpu == r_cpu):
        fail("small sgpr_reduce disagrees between the card and the CPU")


def main() -> None:
    try:
        import torch
    except ImportError as err:
        fail(f"PyTorch is not importable: {err}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import importlib

        wrappers = {k["name"]: importlib.import_module(k["module"]) for k in KERNELS}
    except ImportError as err:
        fail(f"optuna_tpu_torch is not importable next to this script: {err}")
    import optuna_tpu_torch

    optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
    profile_asks = "--profile" in sys.argv[1:]
    print("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    gpu = gpu_line()
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    rows = [phase_matern(device), phase_nds(device), phase_wfg_kernel(device)]
    phase_small_sparse(device)

    def reset():
        for mod in wrappers.values():
            mod.LAUNCHES = 0

    def counts():
        return {name: mod.LAUNCHES for name, mod in wrappers.items()}

    reset()
    exact_s = run_asks("exact engine", 1000, 3, profile_asks)
    after_exact = counts()
    sparse_s = run_asks("sparse engine", 4000, 8, profile_asks)
    gp = counts()
    sparse_launches = gp["matern52_gram"] - after_exact["matern52_gram"]
    reset()
    nsga_s = phase_nsga()
    nsga = counts()
    reset()
    hv_s = phase_hv()
    hv = counts()
    launches = {"matern52_gram": gp["matern52_gram"], "nds": nsga["nds"], "wfg_limit_filter": hv["wfg_limit_filter"]}
    print(
        f"launches on the paths: {launches} (GP exact {after_exact}, sparse {sparse_launches} over "
        f"{8 + int(profile_asks)} asks; NSGA-II {nsga}; hypervolume {hv})"
    )
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} never launched on its path")
    if sparse_launches < 8:
        fail(f"matern52_gram launched {sparse_launches} times over the sparse asks")
    if launches["nds"] < 2:
        fail(f"nds launched {launches['nds']} times over NSGA-II generations 2 and 3")
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_thresholds()

    print(
        f"gpu: {gpu} | exact median {float(np.median(exact_s)):.4f} s/ask, "
        f"sparse median {float(np.median(sparse_s)):.4f} s/ask, NSGA-II {nsga_s:.2f} s, "
        f"hypervolume {hv_s:.2f} s, total {time.perf_counter() - t_start:.1f} s"
    )
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
