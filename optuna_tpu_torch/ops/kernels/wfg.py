"""One WFG stack-machine node: the hand-written CUDA kernel and its plain
PyTorch version (port of ``optuna_tpu/ops/pallas/wfg.py``).

:func:`limit_and_filter` clamps a frame to the pivot, Pareto-filters the
clamped eligible rows (duplicates keep the lowest index) and fills pruned
rows at the reference point, as the reference's XLA twin
``_limit_filter_xla`` does. For CUDA tensors it launches
``csrc/wfg_limit_filter.cu`` or raises; for CPU tensors it runs
:func:`limit_and_filter_plain`. Max, compares and selects only, so the two
are bit-exact.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SOURCE = "wfg_limit_filter.cu"

#: Objectives the kernel supports (a thread keeps its row in registers).
MAX_OBJECTIVES = 16
#: Shared memory a frame may take: the clamped points and the eligibility
#: bytes, within the 48 KB a block gets without opting in (less the
#: kernel's own static buffer).
MAX_FRAME_BYTES = 48 * 1024 - 256

#: Kernel launches since the last reset; counts only real launches.
LAUNCHES = 0


def limit_and_filter_plain(
    pts: torch.Tensor, p: torch.Tensor, eligible: torch.Tensor, ref: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(child_pts, child_msk)`` with broadcast ops (the reference's twin)."""
    n = pts.shape[0]
    child = torch.maximum(pts, p[None, :])
    eff = torch.where(eligible[:, None], child, torch.inf)
    leq = torch.all(eff[:, None, :] <= eff[None, :, :], dim=2)
    strict = torch.any(eff[:, None, :] < eff[None, :, :], dim=2)
    idx = torch.arange(n, device=pts.device)
    earlier = idx[:, None] < idx[None, :]
    dominated = torch.any(leq & (strict | earlier) & eligible[:, None], dim=0)
    child_msk = eligible & ~dominated
    return torch.where(child_msk[:, None], child, ref[None, :]), child_msk


@functools.cache
def _launcher():
    """The built kernel's C entry point, with its argument types declared."""
    from optuna_tpu_torch.ops.kernels import _nvcc

    fn = _nvcc.load(_SOURCE).wfg_limit_filter_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(pts, p, eligible, ref) -> tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    dev = pts.device
    for name, t in (("p", p), ("eligible", eligible), ("ref", ref)):
        if t.device != dev:
            raise ValueError(f"limit_and_filter: {name} is on {t.device}, pts on {dev}.")
    for name, t in (("pts", pts), ("p", p), ("ref", ref)):
        if t.dtype != torch.float32:
            raise TypeError(f"limit_and_filter: {name} must be float32, got {t.dtype}.")
    if eligible.dtype != torch.bool:
        raise TypeError(f"limit_and_filter: eligible must be bool, got {eligible.dtype}.")
    if pts.dim() != 2:
        raise ValueError(f"limit_and_filter: pts {tuple(pts.shape)} must be (n, m).")
    n, m = pts.shape
    if p.shape != (m,) or ref.shape != (m,) or eligible.shape != (n,):
        raise ValueError("limit_and_filter: p and ref must be (m,), eligible (n,).")
    frame_bytes = 4 * n * m + n
    if m > MAX_OBJECTIVES or frame_bytes > MAX_FRAME_BYTES:
        raise ValueError(
            f"limit_and_filter: a frame of ({n}, {m}) is outside what the kernel supports: "
            f"at most {MAX_OBJECTIVES} objectives and 4*n*m + n <= {MAX_FRAME_BYTES} bytes "
            f"of shared memory (n = 1024 at m = 8); got {frame_bytes}."
        )
    pc, p_c, rc = pts.contiguous(), p.contiguous(), ref.contiguous()
    el = eligible.contiguous()
    out_pts = torch.empty((n, m), dtype=torch.float32, device=dev)
    out_msk = torch.empty((n,), dtype=torch.bool, device=dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            pc.data_ptr(), p_c.data_ptr(), el.data_ptr(), rc.data_ptr(),
            out_pts.data_ptr(), out_msk.data_ptr(), n, m, stream,
        )
    if err != 0:
        raise RuntimeError(f"limit_and_filter kernel launch failed: CUDA error {err}.")
    LAUNCHES += 1
    return out_pts, out_msk


def limit_and_filter(
    pts: torch.Tensor, p: torch.Tensor, eligible: torch.Tensor, ref: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One WFG stack-body step: ``(child_pts, child_msk)``.

    ``pts`` (N, M) frame points, ``p`` (M,) pivot, ``eligible`` (N,) bool
    rows still in the frame, ``ref`` (M,) reference point. The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.
    """
    if pts.device.type == "cuda":
        return _launch(pts, p, eligible, ref)
    if pts.device.type == "cpu":
        return limit_and_filter_plain(pts, p, eligible, ref)
    raise ValueError(f"limit_and_filter: unsupported device {pts.device}.")
