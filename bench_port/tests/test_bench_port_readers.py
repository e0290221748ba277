"""Each metric's reader on a small canned trace and telemetry snapshot,
and the shape-based FLOP count of the trainer against a hand count."""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.costs import mlp as mlp_cost
from bench_port import trace as trace_mod
from bench_port.trace import Interval, Op, Trace

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
PEAKS = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
MLP = json.loads((ROOT / "bench_port" / "configs" / "mlp_mnist_b256.json").read_text())


def hist(total: float, count: int) -> dict:
    return {"sum": total, "count": count, "buckets": {}}


# A 10 s window: kernels busy 1-3 s and 6-7 s (3 s busy), a dispatch range
# over 0.5-4 s, an ask range over 4-6 s holding a fit over 4-5 s. The
# kernels running at 1-3 s were launched inside the dispatch; the one at
# 6-7 s inside the ask.
TRACE = Trace(
    ops=[Op("k_a", 1.0, 2.5, 0.9), Op("k_b", 2.0, 3.0, 1.1), Op("k_a", 6.0, 7.0, 4.5), Op("k_c", 11.0, 12.0, 10.5)],
    ranges=[
        Interval("bench_port.window", 0.0, 10.0),
        Interval("optuna_tpu_torch.dispatch", 0.5, 4.0),
        Interval("optuna_tpu_torch.ask", 4.0, 6.0),
        Interval("optuna_tpu_torch.ask.fit", 4.0, 5.0),
    ],
    window=(0.0, 10.0),
)
TELEMETRY = {"histograms": {"phase.ask": hist(0.2, 4), "phase.dispatch": hist(2.0, 4), "phase.tell": hist(0.08, 4)}}


def record(counts: dict, **kw) -> harness.RunRecord:
    base = dict(
        workload={}, config=MLP, traffic={"batch_size": 256}, setup_s=12.5, window_s=20.0, counts=counts,
        peak_bytes=3 * 2**30, device_name="NVIDIA H100 80GB HBM3", peaks=PEAKS, telemetry=TELEMETRY, trace=TRACE,
    )
    base.update(kw)
    return harness.RunRecord(**base)


def test_trace_reduction():
    assert TRACE.busy_s == pytest.approx(3.0)
    assert TRACE.idle_gaps() == [(0.0, 1.0), (3.0, 6.0), (7.0, 10.0)]
    assert TRACE.top_ops(2) == [["k_a", 2.5], ["k_b", 1.0]]
    gaps = dict(map(tuple, TRACE.gaps_by_range()))
    # 0-1 starts before the dispatch opens and 7-10 after everything has
    # closed (the window's own); 3-6 starts inside the dispatch.
    assert gaps == pytest.approx({"dispatch": 3.0, "window": 4.0})
    assert TRACE.device_s_under("dispatch") == pytest.approx(2.0)
    # The kernel at 6-7 s was launched at 4.5 s, inside the fit.
    assert TRACE.device_s_under("ask.fit") == pytest.approx(1.0)
    assert TRACE.device_s_under("tell") is None


def test_device_time_follows_the_launch_not_the_start():
    # An asynchronous dispatch: its kernels run after the range has closed,
    # and a kernel launched before it opened runs inside it.
    t = Trace(
        ops=[Op("late", 5.0, 6.0, 1.5), Op("early", 1.2, 1.8, 0.5), Op("inner", 1.9, 2.0, 1.9)],
        ranges=[Interval("bench_port.window", 0.0, 10.0), Interval("optuna_tpu_torch.dispatch", 1.0, 2.0)],
        window=(0.0, 10.0),
    )
    assert t.device_s_under("dispatch") == pytest.approx(1.1)


class _Event:
    """The few methods of a profiler event that the reduction calls."""

    def __init__(self, name, start_s, dur_s, device, corr, linked=0):
        self._v = (name, int(start_s * 1e9), int(dur_s * 1e9), device, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CPU if self._v[3] == "cpu" else DeviceType.CUDA

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return False


def test_launches_from_profiler_events():
    # Framework ops 7 and 8 (linked to nothing; op 101 shares a number
    # with a runtime call); runtime call 101 launched kernel 101 inside the
    # dispatch, which runs after it closes; kernels 102 and 103 have no
    # runtime call and keep their own starts.
    events = [
        _Event("bench_port.window", 0.0, 10.0, "cpu", 1),
        _Event("optuna_tpu_torch.dispatch", 1.0, 1.0, "cpu", 2),
        _Event("aten::mm", 1.1, 0.1, "cpu", 7),
        _Event("cudaLaunchKernel", 1.15, 0.01, "cpu", 101, linked=7),
        _Event("aten::add", 3.0, 0.1, "cpu", 8),
        _Event("aten::relu", 0.2, 0.1, "cpu", 101),
        _Event("gemm", 4.0, 1.0, "cuda", 101, linked=7),
        _Event("add", 3.5, 0.5, "cuda", 102, linked=8),
        _Event("copy", 1.5, 0.25, "cuda", 103),
    ]
    t = trace_mod.from_events(events)
    launches = {o.name: o.launch for o in t.ops}
    assert launches == pytest.approx({"gemm": 1.15, "add": 3.5, "copy": 1.5})
    assert t.device_s_under("dispatch") == pytest.approx(1.25)
    assert t.busy_s == pytest.approx(1.75)


def test_batch_readers():
    run = record({"batch_trials": 512})
    flops = 512 * mlp_cost.train_flops(MLP)
    assert harness.load_reader("batch_trials_per_s")(run) == pytest.approx(512 / 20.0)
    assert harness.load_reader("batch_ask_ms")(run) == pytest.approx(50.0)
    assert harness.load_reader("dispatch_ms.batch")(run) == pytest.approx(500.0)
    assert harness.load_reader("device_idle_pct.batch")(run) == pytest.approx(70.0)
    assert harness.load_reader("batch_mfu_pct")(run) == pytest.approx(100 * flops / (10.0 * 67e12))
    # Compute-bound: the least time is the FLOPs at the float32 peak, over
    # the 2 s of device time launched inside the dispatch range.
    assert harness.load_reader("train_roofline")(run) == pytest.approx(100 * (flops / 67e12) / 2.0)


@pytest.mark.parametrize("name", [m["name"] for m in MANIFEST["per_layer"]])
def test_readers_find_nothing_without_their_source(name):
    run = record({}, telemetry=None, trace=None, peaks=None)
    assert harness.load_reader(name)(run) is None


def test_train_flops_hand_count():
    # 60,000 x 784 -> 32 -> 10: forward 2*N*(784*32 + 32*10) = 3.04896e9;
    # backward 2*N*(784*32 + 2*32*10) = 3.0873e9; ten steps and a forward.
    forward = 2 * 60000 * (784 * 32 + 320)
    backward = 2 * 60000 * (784 * 32 + 640)
    assert forward == 3_048_960_000 and backward == 3_087_360_000
    assert mlp_cost.train_flops(MLP) == 10 * (forward + backward) + forward
    # A batch of 256 is ~1.65e13 FLOP, 0.246 s at the float32 peak.
    assert 256 * mlp_cost.train_flops(MLP) / 67e12 == pytest.approx(0.2461, rel=1e-3)
    assert mlp_cost.batch_bytes(MLP, 256) == pytest.approx(4 * 60000 * 784 + 8 * 60000 + 4 * 25450 + 256 * 12)
    assert math.isfinite(mlp_cost.batch_bytes(MLP, 1))
