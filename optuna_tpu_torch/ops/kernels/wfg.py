"""The WFG hypervolume on the card: the hand-written CUDA kernels and their
plain PyTorch versions (port of ``optuna_tpu/ops/pallas/wfg.py`` and of the
``lax.while_loop`` in ``optuna_tpu/ops/wfg.py``).

Two entry points share one source, ``csrc/wfg_limit_filter.cu``, and one
device function for the node step:

* :func:`limit_and_filter` runs one node: it clamps a frame to the pivot,
  Pareto-filters the clamped eligible rows (duplicates keep the lowest
  index) and fills pruned rows at the reference point, as the reference's
  XLA twin ``_limit_filter_xla`` does. Max, compares and selects only, so
  the kernel and :func:`limit_and_filter_plain` are bit-exact.
* :func:`wfg_stack` runs whole hypervolumes: one thread block per prepared
  root frame walks the WFG stack from the root to the empty stack inside
  the kernel, one launch for the whole batch. :func:`wfg_stack_plain` is
  the same stack machine in torch ops, one node at a time; both add the
  same float32 terms in the same order, so they give the same bits and the
  same node counts.

For CUDA tensors each wrapper launches its kernel or raises; for CPU
tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

_SOURCE = "wfg_limit_filter.cu"

#: Launches of the node kernel (:func:`limit_and_filter`) since the last reset.
LAUNCHES = 0
#: Launches of the stack kernel (:func:`wfg_stack`) since the last reset.
STACK_LAUNCHES = 0
#: Both launch counts are raised under this lock: worker threads of
#: ``optimize(n_jobs=...)`` launch together.
_COUNT_LOCK = threading.Lock()

#: Bodies of :func:`wfg_stack_plain` between two host reads of ``depth``.
NODES_PER_SYNC = 32

#: Counters of the stack machine since the last reset: ``nodes`` (stack
#: iterations), ``bodies`` (node steps run: whole chunks of
#: :data:`NODES_PER_SYNC` in the plain loop, one per node in the kernel) and
#: ``syncs`` (host reads: one per chunk in the plain loop, one per
#: :func:`wfg_stack` call on the card).
STATS = {"nodes": 0, "bodies": 0, "syncs": 0}

#: Scratch one stack launch may take; a larger batch is split into launches.
MAX_SCRATCH_BYTES = 1 << 30


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


def limit_and_filter_plain(
    pts: torch.Tensor, p: torch.Tensor, eligible: torch.Tensor, ref: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(child_pts, child_msk)`` with broadcast ops (the reference's twin).
    Leading dims of ``pts`` (..., N, M), ``p`` (..., M) and ``eligible``
    (..., N) are a batch of independent frames."""
    n = pts.shape[-2]
    child = torch.maximum(pts, p[..., None, :])
    eff = torch.where(eligible[..., None], child, torch.inf)
    leq = torch.all(eff[..., :, None, :] <= eff[..., None, :, :], dim=-1)
    strict = torch.any(eff[..., :, None, :] < eff[..., None, :, :], dim=-1)
    idx = torch.arange(n, device=pts.device)
    earlier = idx[:, None] < idx[None, :]
    dominated = torch.any(leq & (strict | earlier) & eligible[..., :, None], dim=-2)
    child_msk = eligible & ~dominated
    return torch.where(child_msk[..., None], child, ref), child_msk


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim (0 where there is none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _prod_last(x: torch.Tensor) -> torch.Tensor:
    """Product over the last dim, left to right: the same rounding on every
    device, where ``torch.prod``'s reduction order is the backend's."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out * x[..., k]
    return out


#: Elements of the (B, N, N, M) compare blocks of one batched plain body.
#: Under torch's parallel grain (32,768), so every op of the plain loop runs
#: on one thread: processes that share the CPU do not fight over threads.
_PLAIN_ELEMENTS = 1 << 15


def _stack_plain(pts0: torch.Tensor, m0: torch.Tensor, ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The stack machine of B sorted root frames in lockstep, one node step
    of every frame a body.

    The whole stack lives on the tensors' device: ``s_pts (B, N+2, N, M)``,
    ``s_msk``, ``s_cur``, ``s_sign`` and the (B,) ``depth`` and ``acc``. The
    body has no Python branch on a tensor value and no host read: it is
    written with ``torch.where`` and index tensors, as the reference's
    ``lax.while_loop`` body is. A frame at ``depth == 0`` changes nothing
    (its writes go to a spare frame, ``N + 1``), so each frame adds the same
    float32 terms in the same order as it would alone. The host reads the
    deepest ``depth`` once every :data:`NODES_PER_SYNC` bodies.
    """
    b, n, m = pts0.shape
    dev = pts0.device
    spare = n + 1  # frame that absorbs the writes of a body run at depth 0
    rows = torch.arange(b, device=dev)
    s_pts = torch.zeros((b, n + 2, n, m), dtype=pts0.dtype, device=dev)
    s_pts[:, 0] = pts0
    s_msk = torch.zeros((b, n + 2, n), dtype=torch.bool, device=dev)
    s_msk[:, 0] = m0
    s_cur = torch.zeros((b, n + 2), dtype=torch.int64, device=dev)
    s_sign = torch.zeros((b, n + 2), dtype=pts0.dtype, device=dev)
    s_sign[:, 0] = 1.0
    idx = torch.arange(n, device=dev)
    depth = torch.ones((b,), dtype=torch.int64, device=dev)
    acc = torch.zeros((b,), dtype=pts0.dtype, device=dev)
    nodes = torch.zeros((b,), dtype=torch.int64, device=dev)

    while True:
        for _ in range(NODES_PER_SYNC):
            active = depth > 0
            top = torch.clamp(depth - 1, min=0)
            pts = s_pts[rows, top]
            msk = s_msk[rows, top]
            sign = s_sign[rows, top]
            cur = s_cur[rows, top]
            remaining = msk & (idx >= cur[:, None])
            has_more = torch.any(remaining, dim=-1) & active
            nxt = _first_true(remaining)
            p = pts[rows, nxt]

            child_pts, child_msk = limit_and_filter_plain(pts, p, msk & (idx > nxt[:, None]), ref)
            n_child = torch.sum(child_msk, dim=-1)
            # The pivot's inclusive volume, and a one-point child's, which is
            # folded in place instead of pushed.
            only = child_pts[rows, _first_true(child_msk)]
            inc, inc_only = _prod_last(ref - torch.stack([p, only]))
            fold = torch.where(n_child == 1, sign * inc_only, 0.0)
            acc = acc + torch.where(has_more, sign * inc - fold, 0.0)

            do_push = has_more & (n_child > 1)
            s_cur[rows, top] = torch.where(has_more, nxt + 1, cur)
            slot = torch.where(active, depth, spare)
            s_pts[rows, slot] = child_pts
            s_msk[rows, slot] = child_msk & do_push[:, None]
            s_cur[rows, slot] = 0
            s_sign[rows, slot] = -sign
            nodes = nodes + active.to(torch.int64)
            depth = torch.where(has_more, depth + do_push.to(torch.int64), depth - active.to(torch.int64))
        STATS["bodies"] += NODES_PER_SYNC
        STATS["syncs"] += 1
        if int(depth.max()) == 0:
            break
    return acc, nodes


def wfg_stack_plain(pts0: torch.Tensor, m0: torch.Tensor, ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(acc (B,), nodes (B,))``: the torch stack machine over the batch, in
    lockstep chunks of rows whose compare blocks hold at most
    :data:`_PLAIN_ELEMENTS` elements. Each row gets the bits and the node
    count it gets alone."""
    b, n, m = pts0.shape
    step = max(1, _PLAIN_ELEMENTS // (n * n * m))
    accs, counts = [], []
    for lo in range(0, b, step):
        acc, nodes = _stack_plain(pts0[lo : lo + step], m0[lo : lo + step], ref)
        accs.append(acc)
        counts.append(nodes)
    nodes = torch.cat(counts)
    STATS["nodes"] += int(nodes.sum())
    return torch.cat(accs), nodes


@functools.cache
def _library():
    """The built library, with its C entry points' argument types declared."""
    from optuna_tpu_torch.ops.kernels import _nvcc

    return _nvcc.load(_SOURCE, _bind)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wfg_limit_filter_launch.argtypes = [ptr] * 7 + [i32] * 2 + [ptr]
    lib.wfg_limit_filter_launch.restype = i32
    lib.wfg_node_work_bytes.argtypes = [i32, i32]
    lib.wfg_node_work_bytes.restype = ctypes.c_longlong
    lib.wfg_stack_launch.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.wfg_stack_launch.restype = i32
    lib.wfg_stack_scratch_bytes.argtypes = [i32, i32]
    lib.wfg_stack_scratch_bytes.restype = ctypes.c_longlong


def _check_float32(fn: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}.")


def _check_device(fn: str, dev: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected {dev}.")


def _scratch(n_bytes: int, dev: torch.device) -> torch.Tensor:
    return torch.empty(max(1, n_bytes), dtype=torch.uint8, device=dev)


def _launch(pts, p, eligible, ref) -> tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    dev = pts.device
    _check_device("limit_and_filter", dev, p=p, eligible=eligible, ref=ref)
    _check_float32("limit_and_filter", pts=pts, p=p, ref=ref)
    if eligible.dtype != torch.bool:
        raise TypeError(f"limit_and_filter: eligible must be bool, got {eligible.dtype}.")
    if pts.dim() != 2 or pts.shape[0] == 0:
        raise ValueError(f"limit_and_filter: pts {tuple(pts.shape)} must be (n, m) with n > 0.")
    n, m = pts.shape
    if p.shape != (m,) or ref.shape != (m,) or eligible.shape != (n,):
        raise ValueError("limit_and_filter: p and ref must be (m,), eligible (n,).")
    pc, p_c, rc, el = pts.contiguous(), p.contiguous(), ref.contiguous(), eligible.contiguous()
    out_pts = torch.empty((n, m), dtype=torch.float32, device=dev)
    out_msk = torch.empty((n,), dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        work = _scratch(lib.wfg_node_work_bytes(n, m), dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wfg_limit_filter_launch(
            pc.data_ptr(), p_c.data_ptr(), el.data_ptr(), rc.data_ptr(),
            out_pts.data_ptr(), out_msk.data_ptr(), work.data_ptr(), n, m, stream,
        )
    if err != 0:
        raise RuntimeError(f"limit_and_filter kernel launch failed: CUDA error {err}.")
    with _COUNT_LOCK:
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


def _launch_stack(pts0, m0, ref) -> tuple[torch.Tensor, torch.Tensor]:
    global STACK_LAUNCHES
    dev = pts0.device
    _check_device("wfg_stack", dev, m0=m0, ref=ref)
    _check_float32("wfg_stack", pts0=pts0, ref=ref)
    if m0.dtype != torch.bool:
        raise TypeError(f"wfg_stack: m0 must be bool, got {m0.dtype}.")
    if pts0.dim() != 3 or pts0.shape[1] == 0:
        raise ValueError(f"wfg_stack: pts0 {tuple(pts0.shape)} must be (B, N, M) with N > 0.")
    b, n, m = pts0.shape
    if m0.shape != (b, n) or ref.shape != (m,):
        raise ValueError("wfg_stack: m0 must be (B, N) and ref (M,).")
    if not (pts0.is_contiguous() and m0.is_contiguous() and ref.is_contiguous()):
        raise ValueError("wfg_stack: pts0, m0 and ref must be contiguous.")
    acc = torch.empty((b,), dtype=torch.float32, device=dev)
    nodes = torch.empty((b,), dtype=torch.int64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        per_block = int(lib.wfg_stack_scratch_bytes(n, m))
        chunk = max(1, MAX_SCRATCH_BYTES // per_block)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, b, chunk):
            hi = min(b, lo + chunk)
            scratch = _scratch(per_block * (hi - lo), dev)
            err = lib.wfg_stack_launch(
                pts0[lo:hi].data_ptr(), m0[lo:hi].data_ptr(), ref.data_ptr(), acc[lo:hi].data_ptr(),
                nodes[lo:hi].data_ptr(), scratch.data_ptr(), hi - lo, n, m, stream,
            )
            if err != 0:
                raise RuntimeError(f"wfg_stack kernel launch failed: CUDA error {err}.")
            with _COUNT_LOCK:
                STACK_LAUNCHES += 1
    total = int(nodes.sum())  # the one host read of the call
    STATS["nodes"] += total
    STATS["bodies"] += total
    STATS["syncs"] += 1
    return acc, nodes


def wfg_stack(pts0: torch.Tensor, m0: torch.Tensor, ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole WFG hypervolumes of B prepared root frames: ``(acc (B,), nodes (B,))``.

    ``pts0`` (B, N, M) float32 points sorted ascending in objective 0 with
    rows off the root mask at ``ref``, ``m0`` (B, N) bool root masks,
    ``ref`` (M,) reference point. ``acc`` is each frame's hypervolume,
    ``nodes`` its stack iterations. The CUDA kernel for CUDA tensors (one
    block per frame, one launch per batch of at most
    :data:`MAX_SCRATCH_BYTES` of stack scratch), the plain version for CPU
    tensors.
    """
    if pts0.device.type == "cuda":
        return _launch_stack(pts0, m0, ref)
    if pts0.device.type == "cpu":
        return wfg_stack_plain(pts0, m0, ref)
    raise ValueError(f"wfg_stack: unsupported device {pts0.device}.")
