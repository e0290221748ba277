"""Rank plumbing of the mesh paths: the process groups, the leader's batch
broadcast, and one dispatch evaluated row-block by row-block across ranks.

The reference is single-controller: one process drives every device of a
``jax.sharding.Mesh``, and a jit dispatch over the mesh fails on every
device at once. PyTorch is SPMD: a ``DeviceMesh`` of N is N ranks, each its
own process and device. This module is what lets the executor keep the
reference's one-dispatch semantics over such ranks:

* :func:`share_batch`: rank 0's packed parameter columns, broadcast to
  every rank, so every rank dispatches the same batch;
* :class:`MeshDispatch`: every rank evaluates the contiguous rows its
  ``trials`` coordinate owns (``rows = b / n_trials_shards``, the row layout
  of the reference's ``NamedSharding(P('trials'))``), then the ranks
  all-gather the rows **and a status** (ok, an error, an out-of-memory
  error, a timed-out evaluation, a device fault). Every rank then raises
  the same agreed error, or returns the same gathered values, so every rank
  takes the same containment branch. A rank whose rows raise does not
  leave the others waiting in the gather;
* :func:`send_stop` / :func:`receive`: the control messages of the
  one-study mode, where rank 0 alone runs the sampler and the storage and
  every other rank follows its dispatches (see
  :mod:`optuna_tpu_torch.parallel.sharded`).

Host bytes (the broadcast, the gather, the ICI journal's exchange) ride a
**gloo** group over CPU tensors: the default group where it is gloo,
otherwise one ``dist.new_group(backend="gloo")`` made once. ``new_group``
is itself collective, so :func:`host_group` is first called at the same
point on every rank (``build_study_mesh``, or the journal's first
exchange). With one rank nothing here runs a collective.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator

import numpy as np
import torch

#: The two mesh axes the sharded study loop understands: ``trials`` carries
#: the batch, ``model`` carries whatever tensor parallelism the user's
#: partition rules express.
MESH_AXES: tuple[str, str] = ("trials", "model")

# Status codes of one rank's evaluation, in the order of precedence with
# which the agreed verdict is taken: a device fault outranks an OOM, which
# outranks a timeout, which outranks any other error.
OK, ERROR, TIMEOUT, OOM, DEVICE_FAULT = range(5)
_STATUS_NAMES = {ERROR: "error", TIMEOUT: "timeout", OOM: "out of memory", DEVICE_FAULT: "device fault"}

_host_groups: dict[int, Any] = {}
_scope = threading.local()


class ShardDispatchError(RuntimeError):
    """A dispatch over a multi-rank mesh failed on at least one rank; every
    rank raises this with the same text, so every rank contains it alike."""


class ShardDeviceFault(ShardDispatchError):
    """A device fault on at least one rank of the mesh: like a local device
    fault, it FAILs the batch and is re-raised, never bisected."""


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    dist = _dist()
    return 1 if dist is None else dist.get_world_size()


def rank() -> int:
    dist = _dist()
    return 0 if dist is None else dist.get_rank()


def host_group() -> Any:
    """The gloo group host bytes ride: ``None`` (the default group) where
    the default group is gloo, else one gloo group over every rank, made on
    first use and kept. Collective on first use where it makes a group."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1 or dist.get_backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _host_groups:
        _host_groups[key] = dist.new_group(backend="gloo")
    return _host_groups[key]


def batch_dim(mesh: Any, batch_axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if batch_axis not in names:
        raise ValueError(f"batch_axis {batch_axis!r} is not a mesh axis {names}.")
    return names.index(batch_axis)


def n_batch_shards(mesh: Any, batch_axis: str) -> int:
    """Shards of the batch: the size of the mesh's ``batch_axis``."""
    return int(mesh.size(batch_dim(mesh, batch_axis)))


def coordinate(mesh: Any) -> list[int]:
    coord = mesh.get_coordinate()
    return [0] * mesh.ndim if coord is None else [int(c) for c in coord]


def mesh_device(mesh: Any) -> torch.device:
    """Where a mesh's DTensors live on this rank: the current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def role(mesh: Any, *, pod: bool) -> str | None:
    """This rank's part in a batch loop over ``mesh``: ``None`` where every
    rank runs the whole loop (no mesh, one rank, or the lockstep pod),
    else ``"leader"`` on rank 0 and ``"follower"`` on the others."""
    if mesh is None or pod or world_size() == 1:
        return None
    return "leader" if rank() == 0 else "follower"


# ------------------------------------------------------------ control plane


def _broadcast(message: Any) -> Any:
    import torch.distributed as dist

    box = [message if rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]


def share_batch(packed: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rank 0's packed columns on every rank (collective; a no-op on one
    rank)."""
    if world_size() == 1:
        return packed
    kind, payload = _broadcast(("batch", packed))
    if kind != "batch":
        raise RuntimeError(f"rank 0 sent {kind!r} where every rank expected a batch: the ranks are out of step.")
    return payload


def send_stop(reason: str | None) -> None:
    """Rank 0 ends the followers' loop; ``reason`` (an error's text) makes
    them raise it."""
    _broadcast(("stop", reason))


def receive() -> tuple[str, Any]:
    """A follower's next message from rank 0: ``("batch", packed)`` or
    ``("stop", reason)``."""
    return _broadcast(None)


# ------------------------------------------------------------ the dispatch


@contextmanager
def deadline_scope(deadline_s: float | None, clock: Callable[[], float] = time.monotonic) -> Iterator[None]:
    """Bound each rank's evaluation of its rows in the dispatches made
    inside: the verdict is then gathered, so every rank reaches it."""
    previous = getattr(_scope, "deadline", None)
    _scope.deadline = None if deadline_s is None else (deadline_s, clock)
    try:
        yield
    finally:
        _scope.deadline = previous


def classify(err: BaseException) -> int:
    """The status of a local evaluation error, as the executor's
    containment reads the same error."""
    from optuna_tpu_torch.parallel.executor import DispatchTimeoutError, _is_oom_error, _is_uncontained_device_fault

    if _is_uncontained_device_fault(err):
        return DEVICE_FAULT
    if _is_oom_error(err):
        return OOM
    if isinstance(err, DispatchTimeoutError):
        return TIMEOUT
    return ERROR


def agreed_error(failures: list[tuple[str, int, str]]) -> Exception:
    """The one error every rank raises for a dispatch that failed on the
    ranks in ``failures`` (``(coordinate, status, text)``)."""
    from optuna_tpu_torch.parallel.executor import DispatchTimeoutError

    status = max(s for _, s, _ in failures)
    text = "; ".join(f"shard {where} ({_STATUS_NAMES[s]}): {msg}" for where, s, msg in failures)
    if status == DEVICE_FAULT:
        return ShardDeviceFault(text)
    if status == OOM:
        return torch.OutOfMemoryError(f"out of memory on the mesh: {text}")
    if status == TIMEOUT:
        return DispatchTimeoutError(text)
    return ShardDispatchError(text)


class MeshDispatch:
    """One dispatch of ``local_fn`` over a mesh: this rank evaluates the
    rows its ``batch_axis`` coordinate owns, and the ranks gather the rows
    with a status each (see the module docstring).

    ``local_fn`` maps this rank's rows (``{name: (rows,) tensor}``) to a
    tensor of values, or to ``(values, finite)`` with ``guarded``.

    Called with tensors alone (a user's call), it returns tensors: with one
    rank ``local_fn``'s own, so a one-rank mesh dispatches exactly as the
    mesh-less path does; with several, the gathered batch on the host.

    Called with ``upload`` (the executor's dispatch), the arguments are host
    tensors and ``upload`` places this rank's rows on the device inside the
    status boundary, so a failed upload is agreed on like a failed
    evaluation; the result is then the host arrays of
    :func:`~optuna_tpu_torch.parallel.executor._read_to_host`, read inside
    the boundary too.

    Ranks off the batch axis's coordinate 0 of the other axes evaluate the
    same rows (a model-parallel objective needs them all); the rows of the
    first are kept.
    """

    def __init__(self, local_fn: Callable, mesh: Any, batch_axis: str, *, guarded: bool) -> None:
        self.local_fn = local_fn
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.guarded = guarded
        self._dim = batch_dim(mesh, batch_axis)
        self._n = n_batch_shards(mesh, batch_axis)

    def __call__(self, args: dict[str, torch.Tensor], upload: Callable | None = None) -> Any:
        if world_size() == 1:
            return self.local_fn(args) if upload is None else self._rows(args, upload)
        width = int(next(iter(args.values())).shape[0]) if args else 0
        if width % self._n:
            raise ValueError(f"a {width}-wide dispatch does not split over {self._n} trials shards; pad it first.")
        rows = width // self._n
        coord = coordinate(self.mesh)
        k = coord[self._dim]
        local = {name: v[k * rows : (k + 1) * rows] for name, v in args.items()}
        scope = getattr(_scope, "deadline", None)
        status, text, host, local_err = OK, "", None, None
        try:
            if scope is None:
                host = self._rows(local, upload)
            else:
                from optuna_tpu_torch.parallel.executor import run_with_deadline

                host = run_with_deadline(
                    lambda: self._rows(local, upload), scope[0], scope[1], describe=f"rows of trials shard {k}"
                )
        except Exception as err:  # graphlint: ignore[PY001] -- status boundary: the error travels in the gather, so every rank raises the agreed one below
            status, text, local_err = classify(err), f"{type(err).__name__}: {err}"[:500], err
        where = "".join(f"{name[0]}{c}" for name, c in zip(self.mesh.mesh_dim_names, coord))
        gathered = self._gather((coord, where, status, text, host))
        failures = [(w, s, t) for _, w, s, t, _ in gathered if s != OK]
        if failures:
            raise agreed_error(failures) from local_err
        keep = [h for c, _, _, _, h in sorted(gathered, key=lambda entry: entry[0][self._dim])
                if all(x == 0 for i, x in enumerate(c) if i != self._dim)]
        values = np.concatenate([h[0] for h in keep])
        finite = np.concatenate([h[1] for h in keep]) if self.guarded else None
        if upload is not None:
            return values, finite
        if not self.guarded:
            return torch.from_numpy(values)
        return torch.from_numpy(values), torch.from_numpy(finite)

    def _rows(self, local: dict[str, torch.Tensor], upload: Callable | None) -> tuple:
        """Evaluate rows and read them to the host with the executor's one
        read: ``(values, finite)`` arrays (``finite`` ``None`` unguarded)."""
        from optuna_tpu_torch.parallel.executor import _read_to_host

        out = self.local_fn(local if upload is None else upload(local))
        return _read_to_host(*out) if self.guarded else _read_to_host(out)

    def _gather(self, entry: tuple) -> list[tuple]:
        import torch.distributed as dist

        out: list = [None] * world_size()
        dist.all_gather_object(out, entry, group=host_group())
        return out
