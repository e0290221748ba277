"""One run of one cell: set-up, a measured window, the metrics, the check.

Everything a run needs is found by name from ``BENCHMARK.json``: the cell
names its configuration (``configs/<file>``) and its traffic mix
(``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``); each metric is read by
``metrics/<metric name>.py``. A driver module defines ``Cell(config,
traffic, seed, device)`` with ``setup()``, ``run_window(seconds, clock)``,
``release()`` and ``check()``, and the attributes ``counts``,
``attempted`` and ``failed`` (see ``drivers/batch_study.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_port_cache"

# Switches of the measured package that would change what a run does; a
# run clears them so that the caller's environment cannot.
_PROGRAM_SWITCHES = (
    "OPTUNA_TPU_TORCH_TRACE",
    "OPTUNA_TPU_TORCH_TELEMETRY",
    "OPTUNA_TPU_TORCH_FLIGHT",
    "OPTUNA_TPU_TORCH_FLIGHT_DUMP_DIR",
    "OPTUNA_TPU_TORCH_AUTOPILOT",
    "OPTUNA_TPU_TORCH_HEALTH",
    "OPTUNA_TPU_TORCH_HEALTH_INTERVAL_S",
    "OPTUNA_TPU_TORCH_SLO",
    "OPTUNA_TPU_TORCH_LOCKSAN",
    "OPTUNA_TPU_TORCH_NO_COMPILE_CACHE",
)


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of the cell named ``workload``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as fh:
        config = json.load(fh)
    with open(root / "bench_port" / "traffic" / f"{cell['traffic']}.json") as fh:
        traffic = json.load(fh)
    return cell, config, traffic


def metrics_for(manifest: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    untraced, the per-layer ones traced; a metric with a ``workloads`` list
    only in those cells."""
    group = manifest["per_layer"] if traced else manifest["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_port_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(traffic: dict):
    return importlib.import_module(f"bench_port.drivers.{traffic['driver']}")


def configure_environment(config: dict) -> None:
    """Before torch is imported: the host's thread count, fixed cache
    directories inside the checkout, and the program's switches cleared."""
    threads = str(int(config["host_threads"]))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = threads
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["OPTUNA_TPU_TORCH_CACHE_DIR"] = str(CACHE / "kernels")
    os.environ["USE_FLAX"] = "0"
    for var in _PROGRAM_SWITCHES:
        os.environ.pop(var, None)


def process_start(fallback: float) -> float:
    """This process's start on the ``time.monotonic`` clock (from
    ``/proc``), or ``fallback`` where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.monotonic() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return fallback


class WindowClock:
    """The measured window as a sum of timed segments (``with clock:``);
    work a driver does between segments, such as a history reset, stays
    out of it."""

    def __init__(self) -> None:
        self.elapsed = 0.0
        self.first_start: float | None = None
        self._t0 = 0.0

    def __enter__(self) -> "WindowClock":
        self._t0 = time.monotonic()
        if self.first_start is None:
            self.first_start = self._t0
        return self

    def __exit__(self, *exc: object) -> None:
        self.elapsed += time.monotonic() - self._t0

    def now(self) -> float:
        """Seconds measured so far, the open segment included."""
        return self.elapsed + (time.monotonic() - self._t0)


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader sees of one run."""

    workload: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    counts: dict
    peak_bytes: int
    device_name: str
    peaks: "dict | None"
    telemetry: "dict | None" = None
    trace: Any = None


def device_peaks(device_name: str) -> "dict | None":
    with open(BENCH / "peaks.json") as fh:
        return json.load(fh).get(device_name)


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def log(msg: str) -> None:
    print(f"[bench_port] {msg}", file=sys.stderr, flush=True)


def run_cell(
    workload: str,
    seed: int,
    seconds: float,
    traced: bool,
    *,
    t_start: float,
    device: str = "cuda",
    manifest: "dict | None" = None,
    config: "dict | None" = None,
    traffic: "dict | None" = None,
) -> dict:
    """Run one cell once; return the result line's object. ``config`` and
    ``traffic`` replace the cell's files (the tests run a small copy)."""
    import torch

    manifest = load_manifest() if manifest is None else manifest
    cell_entry, file_config, file_traffic = resolve(manifest, workload)
    config = file_config if config is None else config
    traffic = file_traffic if traffic is None else traffic
    torch.set_num_threads(int(config["host_threads"]))
    on_card = torch.device(device).type == "cuda"
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    if on_card:
        torch.cuda.init()
    log(f"set-up: torch imported and the device ready at {time.monotonic() - t_start:.3f} s")

    driver = load_driver(traffic)
    cell = driver.Cell(config, traffic, seed, torch.device(device))
    cell.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"set-up: data and warm-up done at {time.monotonic() - t_start:.3f} s")

    clock = WindowClock()
    prof = snapshot = None
    if traced:
        from optuna_tpu_torch import telemetry

        telemetry.enable(telemetry.MetricsRegistry())
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    with torch.profiler.record_function("bench_port.window"):
        cell.run_window(seconds, clock)
        if on_card:
            torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    setup_s = clock.first_start - t_start
    if on_card:
        log(f"card: {power_line()}")
    trace = None
    if traced:
        from bench_port import trace as trace_mod
        from optuna_tpu_torch import telemetry

        snapshot = telemetry.snapshot()
        telemetry.disable()
        t0 = time.monotonic()
        prof.__exit__(None, None, None)
        trace = trace_mod.from_profiler(prof)
        prof = None
        log(f"trace read in {time.monotonic() - t0:.1f} s: {len(trace.ops)} device ops in the window")

    record = RunRecord(
        workload=cell_entry, config=config, traffic=traffic, setup_s=setup_s, window_s=clock.elapsed,
        counts=dict(cell.counts), peak_bytes=peak, device_name=device_name, peaks=device_peaks(device_name),
        telemetry=snapshot, trace=trace,
    )
    metrics = {}
    for m in metrics_for(manifest, workload, traced):
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(
        f"window {clock.elapsed:.3f} s, counts {cell.counts}, attempted {cell.attempted}, failed {cell.failed}, "
        f"setup {setup_s:.3f} s, peak {peak} bytes"
    )
    result: dict = {
        "correct": False,
        "attempted": int(cell.attempted),
        "failed": int(cell.failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": device_name,
                   "count": int(cell_entry["chips"]), "memory_peak_bytes": peak},
    }
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(10), "idle_gaps": trace.gaps_by_range(10)}
        log(f"breakdown {json.dumps(result['breakdown'])}")

    # The check runs once the window's state is freed, so the reference
    # neither sets the memory peak nor competes with the program.
    cell.release()
    record = trace = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    try:
        checks = cell.check()
        correct = bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    except Exception:  # the check's boundary: a comparison that fails to run is a run that is not correct
        traceback.print_exc()
        checks, correct = {}, False
    log(f"check took {time.monotonic() - t0:.1f} s")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["correct"] = correct
    result["checks"] = checks
    return result
