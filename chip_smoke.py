"""Quickest proof that optuna_tpu_torch runs its main path on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # also trace one more ask of each engine

Phases (any failure exits non-zero and prints no result line):

1. Build every CUDA kernel of the path from ``optuna_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, all started together).
2. Hold each kernel against its plain PyTorch version and a float64 oracle on
   the card, at the main path's shapes and at ragged and categorical ones, and
   time it, its plain version and its bound with CUDA events.
3. Exact engine: a GPSampler study on Hartmann-20D with 1000 seeded completed
   trials, then 3 GP asks.
4. Sparse engine: the same with 4000 trials and 8 GP asks, each through the
   SGPR program and its CUDA Matérn Gram (m = 256, N bucket 4096).
5. A small sparse reduction on the card against the same code on the CPU.

The kernel launch counters are set to 0 just before phase 3 and read just
after phase 4; every kernel of the path must have launched. The line before
the last is the kernel table as JSON; the last line is the device summary.
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
]
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TOL_VS_PLAIN = 1e-6  # f32 kernel against the f32 plain version: summation order only
TOL_VS_F64 = 1e-6  # the reference's XLA twin is 2.2e-7 from f64 at (37, 23, 5)
SMALL_TOL = 2e-3  # card vs CPU on a small sparse reduction: Cholesky/triangular-solve order


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
    ms = graph_ms(lambda: matern.matern52_gram(*args))
    plain_ms = graph_ms(lambda: matern.matern52_gram_plain(*args))
    call_ms = cuda_ms(lambda: matern.matern52_gram(*args))
    plain_call_ms = cuda_ms(lambda: matern.matern52_gram_plain(*args))
    n_bytes = 4 * (n1 * d + n2 * d + d + 1 + n2 * n1) + d  # inputs read once, output written once
    n_ops = n1 * n2 * (3 * d + 9)  # sub, mul, fma per dim; sqrt, exp and 7 flops per element
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"matern52_gram time at ({n1}, {n2}, {d}): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms "
        f"(device time, CUDA graph); per call with host overhead: kernel {call_ms:.4f} ms, "
        f"plain {plain_call_ms:.4f} ms; "
        f"bound {bound_ms:.5f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}: "
        f"{n_bytes} B, {n_ops} flops); no single PyTorch call computes this function"
    )
    return {
        "name": "matern52_gram",
        "route": "cuda",
        "source": KERNELS[0]["source"],
        "replaces": KERNELS[0]["replaces"],
        "max_abs_err": worst_plain,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


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


def profiled(label: str, fn) -> None:
    """Run ``fn`` under torch.profiler; print the device's busy share and the
    top operators, and write the full table to chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))  # noqa: E731
    busy_ms = sum(dev(e) for e in events) / 1e3
    launches = sum(e.count for e in events if dev(e) > 0)
    top = sorted(events, key=dev, reverse=True)[:8]
    print(
        f"profile {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {launches} device-timed ops; top: "
        + "; ".join(f"{e.key[:48]} x{e.count} {dev(e) / 1e3:.2f} ms" for e in top)
    )
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"profile_{label.replace(' ', '_')}.txt"), "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=60))


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
    rows = [phase_matern(device)]
    phase_small_sparse(device)

    for mod in wrappers.values():
        mod.LAUNCHES = 0
    exact_s = run_asks("exact engine", 1000, 3, profile_asks)
    after_exact = {name: mod.LAUNCHES for name, mod in wrappers.items()}
    sparse_s = run_asks("sparse engine", 4000, 8, profile_asks)
    launches = {name: mod.LAUNCHES for name, mod in wrappers.items()}
    sparse_launches = launches["matern52_gram"] - after_exact["matern52_gram"]
    print(f"launches on the main path: {launches} (exact phase {after_exact}, sparse phase {sparse_launches} over {8 + int(profile_asks)} asks)")
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} never launched on the main path")
    if sparse_launches < 8:
        fail(f"matern52_gram launched {sparse_launches} times over the sparse asks")
    for row in rows:
        row["launches"] = launches[row["name"]]

    print(
        f"gpu: {gpu} | exact median {float(np.median(exact_s)):.4f} s/ask, "
        f"sparse median {float(np.median(sparse_s)):.4f} s/ask, total {time.perf_counter() - t_start:.1f} s"
    )
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
