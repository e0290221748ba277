"""Sharded study execution: trials x model on one 2-D ``DeviceMesh`` (port of
``optuna_tpu/parallel/sharded.py``).

A ``{'trials', 'model'}`` mesh whose ``trials`` axis carries the batch
(data parallelism over trials) and whose ``model`` axis carries the user's
model (tensor parallelism inside each trial, as ``DTensor`` placements).

* **Partition rules** (:func:`match_partition_rules` /
  :func:`make_shard_and_gather_fns`): each leaf of the user's model (nested
  dicts, lists, tuples, NamedTuples) gets its spec by first-match regex over
  its ``/``-joined name. A spec is a plain tuple of mesh axis names or
  ``None`` per tensor dimension (``(None, "model")``, ``()``), as the
  reference's ``PartitionSpec`` is. Scalars replicate, and an unmatched
  non-scalar leaf is a loud error, never a silent replication. The shard
  function places a numpy or torch leaf as a ``DTensor`` with ``Shard(i)``
  on each mesh dimension its spec names at position ``i`` and
  ``Replicate()`` on the others; the gather function returns it as numpy.
* **Per-shard containment** (:class:`ShardedBatchExecutor`): a crashing
  dispatch is split along shard-group boundaries first (the rows each
  ``trials`` shard owned), so a poison trial FAILs its shard's rows while
  every other shard's trials are salvaged in one re-dispatch each; OOM
  halving floors at one row a shard; heartbeat reap and retry clones are
  inherited unchanged.
* **Pod trial sync** (:class:`PodFollowerStorage`): a study over
  ``JournalStorage(IciJournalBackend())`` syncs trials through the
  journal's all-gather exchange; rank 0 leads the writes, every other rank
  runs the same loop with its writes mirrored, and one barrier exchange
  closes every batch (the ``shard.exchange`` phase).
* **Observability**: ``shard.width`` / ``shard.quarantined`` /
  ``shard.contained_groups`` device stats, the ``shard.trials.t<k>.total``
  throughput gauges that the doctor's ``shard.imbalance`` check reads, and
  health worker ids ``<host>-<pid>-t<i>m<j>``.

**Which process drives the mesh.** The reference is single-controller: one
process drives every device of its mesh, with one study writer and one jit.
PyTorch is SPMD: a mesh of N is N ranks, each a process with its device,
and every rank calls the same entry point. The two run modes of the
reference map onto ranks so:

1. *One logical study* (every storage but the ICI journal; the
   reference's one-process mesh). Rank 0 alone runs the sampler and
   touches the storage. Each dispatch, it broadcasts the packed parameter
   columns (the ``_pack_params`` output, padded to a multiple of the
   ``trials`` shards) over the group; every rank evaluates the contiguous
   rows its ``trials`` coordinate owns (``rows = b / n_trials_shards``) and
   the ranks all-gather the values, the finite mask and a status each.
   Ranks other than 0 run only that receive-evaluate-gather loop, ignore
   ``study`` (it may be None) and return when rank 0's run ends, raising
   where it raised an error. Without this mode a 2 x 2 mesh over one sqlite
   file would create every trial four times.
2. *The pod* (``JournalStorage(IciJournalBackend())``, the reference's
   multi-process run). Every rank runs the same loop in lockstep: rank 0
   appends, every other rank's storage is wrapped in
   :class:`PodFollowerStorage`, which paces one exchange for each mirrored
   write, one barrier exchange closes each batch, and health publishing is
   suppressed for the run. Each dispatch still takes rank 0's columns.

One rank is both modes at once, and trial for trial the same run as
``optimize_vectorized``. A failure is agreed on before anyone acts: the
gather carries each rank's status, so a poison row, an OOM or a timed-out
evaluation on one rank is the same error on every rank, which then takes
the same containment branch (rank 0's, in mode 1). A device fault is
re-raised; a worker's death (``BaseException``) goes through uncaught.
Every process group should have a finite ``timeout``, so that a lost rank
fails the others instead of hanging them. Multi-card runs start under
``torchrun`` with NCCL; host bytes then ride a gloo group of their own.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Any, Callable, Mapping, Sequence

import numpy as np
import torch

from optuna_tpu_torch import device_stats, flight, health, telemetry
from optuna_tpu_torch import checkpoint as _ckpt
from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.parallel import _mesh
from optuna_tpu_torch.parallel._mesh import MESH_AXES, MeshDispatch
from optuna_tpu_torch.parallel.executor import ResilientBatchExecutor, build_non_finite_guard
from optuna_tpu_torch.parallel.ici_journal import IciJournalBackend
from optuna_tpu_torch.parallel.vectorized import VectorizedObjective
from optuna_tpu_torch.storages._base import BaseStorage, _ForwardingStorage
from optuna_tpu_torch.storages.journal._storage import JournalStorage
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

    from optuna_tpu_torch.distributions import BaseDistribution
    from optuna_tpu_torch.storages._retry import RetryPolicy
    from optuna_tpu_torch.study.study import Study
    from optuna_tpu_torch.trial._trial import Trial


_logger = get_logger(__name__)

# ------------------------------------------------------------ partition rules


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_map(f: Callable, tree: Any, *rest: Any, is_leaf: Callable[[Any], bool] | None = None, path: tuple = ()) -> Any:
    """``f(path, leaf, *leaves of rest)`` over ``tree``'s leaves, keeping its
    structure; ``path`` names a leaf as the reference's ``_leaf_name`` does
    (dict keys, NamedTuple field names, sequence indices)."""
    if is_leaf is not None and is_leaf(tree):
        return f(path, tree, *rest)
    if isinstance(tree, Mapping):
        return {k: _tree_map(f, v, *(r[k] for r in rest), is_leaf=is_leaf, path=path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            _tree_map(f, getattr(tree, name), *(getattr(r, name) for r in rest), is_leaf=is_leaf, path=path + (name,))
            for name in tree._fields
        ))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _tree_map(f, v, *(r[i] for r in rest), is_leaf=is_leaf, path=path + (str(i),)) for i, v in enumerate(tree)
        )
    if tree is None:
        return None
    return f(path, tree, *rest)


def _is_spec(x: Any) -> bool:
    """A partition spec: ``None`` or a plain tuple of axis names, ``None``s
    and tuples of axis names."""
    if x is None:
        return True
    return (
        isinstance(x, tuple)
        and not _is_namedtuple(x)
        and all(e is None or isinstance(e, str) or (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)
    )


def _shape(leaf: Any) -> tuple[int, ...]:
    shape = getattr(leaf, "shape", None)
    return tuple(int(s) for s in (np.shape(leaf) if shape is None else shape))


def match_partition_rules(rules: Sequence[tuple[str, Any]], tree: Any) -> Any:
    """A tree of partition specs for ``tree``: each leaf takes the spec of
    the first ``(regex, spec)`` rule whose pattern ``re.search``-matches its
    ``/``-joined name. Scalar leaves (0-d or single-element) replicate
    (``()``) without consulting the rules, and a non-scalar leaf no rule
    matches raises: a silently replicated tensor is memory on every card, so
    "no rule" must be loud."""
    compiled = [(re.compile(pattern), spec) for pattern, spec in rules]

    def spec_for(path: tuple, leaf: Any) -> Any:
        name = "/".join(path)
        shape = _shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return ()  # scalars replicate
        for pattern, spec in compiled:
            if pattern.search(name) is not None:
                return spec
        raise ValueError(
            f"no partition rule matched model leaf {name!r} (shape {shape}); "
            "add a rule (regex, spec) covering it: every non-scalar "
            "model leaf must state its sharding explicitly."
        )

    return _tree_map(spec_for, tree)


def _placements(mesh: "DeviceMesh", spec: Any, ndim: int) -> list:
    from torch.distributed.tensor import Replicate, Shard

    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"partition spec {spec} has more entries than the leaf's {ndim} dimensions.")
    placements = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return placements


def make_shard_and_gather_fns(mesh: "DeviceMesh", partition_specs: Any) -> tuple[Any, Any]:
    """Trees of per-leaf shard and gather callables from a tree of specs:
    ``shard_fn(leaf)`` places a numpy or torch leaf on ``mesh`` as a
    ``DTensor`` (each rank keeps its own block of the full value it holds,
    so placing needs no collective); ``gather_fn(leaf)`` returns the full
    value as a numpy array. On several ranks the gather is a **collective**
    (``full_tensor()``): every rank calls the gather fns together."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    device = _mesh.mesh_device(mesh)

    def make_shard_fn(_path: tuple, spec: Any) -> Callable:
        def shard(leaf: Any) -> Any:
            value = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
            value = value.to(device)
            return distribute_tensor(value, mesh, _placements(mesh, spec, value.dim()), src_data_rank=None)

        return shard

    def make_gather_fn(_path: tuple, _spec: Any) -> Callable:
        def gather(leaf: Any) -> np.ndarray:
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()
            return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)

        return gather

    shard_fns = _tree_map(make_shard_fn, partition_specs, is_leaf=_is_spec)
    gather_fns = _tree_map(make_gather_fn, partition_specs, is_leaf=_is_spec)
    return shard_fns, gather_fns


def _apply(fns: Any, tree: Any) -> Any:
    return _tree_map(lambda _path, fn, leaf: fn(leaf), fns, tree, is_leaf=callable)


def build_study_mesh(
    mesh_shape: Mapping[str, int] | None = None,
    *,
    devices: Sequence[int] | None = None,
    device: "str | torch.device | None" = None,
) -> "DeviceMesh":
    """The study's 2-D ``(trials, model)`` ``DeviceMesh``. ``mesh_shape``
    maps axis name to size (missing axes default to 1; ``None`` puts every
    rank on ``trials``). ``devices`` lists the ranks to lay out (default:
    every rank of the default group, in order). Asking for more ranks than
    that is an error, not a wrap, and the mesh must span every rank of the
    group, since each dispatch gathers over the group.

    ``device`` is where the mesh's tensors live: ``None`` is the card (NCCL;
    it raises where there is none), ``"cpu"`` the CPU (gloo). With no
    default process group a 1 x 1 mesh starts a one-rank group over a
    ``dist.HashStore`` (no address is read); a larger one needs the group
    started first (``torchrun``, or ``init_process_group``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dev = resolve_device(device)
    ranks = list(range(_mesh.world_size())) if devices is None else [int(r) for r in devices]
    if mesh_shape is None:
        mesh_shape = {"trials": len(ranks), "model": 1}
    unknown = set(mesh_shape) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the sharded study loop understands exactly {MESH_AXES}.")
    n_trials_axis = int(mesh_shape.get("trials", 1))
    n_model_axis = int(mesh_shape.get("model", 1))
    if n_trials_axis < 1 or n_model_axis < 1:
        raise ValueError(f"mesh axis sizes must be >= 1; got {dict(mesh_shape)}.")
    need = n_trials_axis * n_model_axis
    if need > len(ranks):
        raise ValueError(
            f"mesh {{'trials': {n_trials_axis}, 'model': {n_model_axis}}} needs "
            f"{need} ranks; only {len(ranks)} available."
        )
    if need < _mesh.world_size():
        raise ValueError(
            f"mesh {{'trials': {n_trials_axis}, 'model': {n_model_axis}}} spans {need} of the group's "
            f"{_mesh.world_size()} ranks; every rank of the group must be on the mesh."
        )
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1)
    if dev.type == "cuda":
        # DeviceMesh reads the current card; a bare "cuda" keeps the current one.
        torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
    _mesh.host_group()  # collective where it makes a group: here, at the same point on every rank
    if ranks[:need] == list(range(need)):
        return init_device_mesh(dev.type, (n_trials_axis, n_model_axis), mesh_dim_names=MESH_AXES)
    grid = torch.tensor(ranks[:need], dtype=torch.int).reshape(n_trials_axis, n_model_axis)
    return DeviceMesh(dev.type, grid, mesh_dim_names=MESH_AXES)


def mesh_worker_id(mesh: "DeviceMesh") -> str:
    """``<host>-<pid>-t<i>m<j>``: the default health worker id extended with
    this rank's mesh coordinates, so the doctor's fleet table (and a
    ``worker.dead`` finding after a rank dies) maps onto the mesh."""
    coords = _mesh.coordinate(mesh)
    suffix = "".join(f"{axis[0]}{coords[k]}" for k, axis in enumerate(mesh.mesh_dim_names))
    return f"{health.default_worker_id()}-{suffix}"


# ----------------------------------------------------------- sharded objective


class ShardedObjective(VectorizedObjective):
    """A batched objective that also takes a model sharded over the mesh's
    ``model`` axis.

    ``fn`` maps ``({name: (B,) DTensor}, model)`` to values of shape
    ``(B,)`` (or ``(B, n_objectives)``), as a ``DTensor`` or as this rank's
    rows. The parameters are ``DTensor`` s sharded along the batch axis
    (``Shard(0)``) and replicated on the others, the global view the
    reference's jit gives; ``model`` is any tree of numpy or torch leaves
    and ``partition_rules`` a sequence of ``(regex, spec)`` pairs resolved
    per leaf by :func:`match_partition_rules`. The model is placed once per
    mesh and cached beside the objective's dispatch wrappers. An operation
    that ``DTensor`` has no sharding rule for may gather a sharded operand
    to a replicated one; :meth:`sharded_model` shows the placements and the
    local shapes to check.
    """

    def __init__(
        self,
        fn: Callable[[dict[str, Any], Any], Any],
        search_space: "dict[str, BaseDistribution]",
        *,
        model: Any,
        partition_rules: Sequence[tuple[str, Any]] = (),
    ) -> None:
        super().__init__(fn, search_space)
        self.model = model
        self.partition_rules = tuple(partition_rules)

    def sharded_model(self, mesh: "DeviceMesh") -> tuple[Any, Any]:
        """``(placed model, partition specs)`` for ``mesh``: the model's
        leaves as ``DTensor`` s, placed once and cached."""
        key = ("sharded_model", mesh)
        cached = self._compiled_cache.get(key)
        if cached is None:
            specs = match_partition_rules(self.partition_rules, self.model)
            shard_fns, _ = make_shard_and_gather_fns(mesh, specs)
            cached = self._compiled_cache[key] = (_apply(shard_fns, self.model), specs)
        return cached

    def gathered_model(self, mesh: "DeviceMesh") -> Any:
        """The placed model back as numpy arrays (the shard and gather round
        trip; collective on several ranks)."""
        placed, specs = self.sharded_model(mesh)
        _, gather_fns = make_shard_and_gather_fns(mesh, specs)
        return _apply(gather_fns, placed)

    def guarded(self, mesh: Any = None, batch_axis: str = "trials", non_finite: str = "fail") -> Callable:
        """The executor's wrapper: ``(values, finite_mask)``, the batch's rows
        sharded along ``batch_axis`` and the model along its rules. Memoized
        per (mesh, axis, policy) like the base class."""
        if mesh is None:
            raise ValueError(
                "ShardedObjective needs a mesh: the model's partition rules "
                "have no meaning without one (use VectorizedObjective for "
                "mesh-less batching)."
            )
        clip = non_finite == "clip"
        key = (mesh, batch_axis, "sharded_guarded", clip)
        cached = self._compiled_cache.get(key)
        if cached is None:
            local = build_non_finite_guard(self._local_fn(mesh, batch_axis), clip=clip)
            dispatch = MeshDispatch(local, mesh, batch_axis, guarded=True)
            cached = self._compiled_cache[key] = flight.instrument_jit(dispatch, "sharded.guarded")
        return cached

    def _local_fn(self, mesh: "DeviceMesh", batch_axis: str) -> Callable:
        """This rank's rows -> ``fn`` on ``DTensor`` s -> this rank's rows."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        model, _ = self.sharded_model(mesh)
        placements = [Shard(0) if name == batch_axis else Replicate() for name in mesh.mesh_dim_names]
        device = _mesh.mesh_device(mesh)

        def local(params: dict[str, torch.Tensor]) -> torch.Tensor:
            dparams = {k: DTensor.from_local(v.to(device), mesh, placements, run_check=False) for k, v in params.items()}
            out = self.fn(dparams, model)
            if isinstance(out, DTensor):
                out = out.redistribute(mesh, placements).to_local()
            return out

        return local


# ------------------------------------------------------------- pod trial sync


def _ici_journal_storage(storage: "BaseStorage") -> JournalStorage | None:
    """The :class:`JournalStorage` over an :class:`IciJournalBackend` behind
    ``storage`` (unwrapping forwarding decorators like ``RetryingStorage``),
    or None when the study is not ICI-journal-backed."""
    seen = 0
    while isinstance(storage, _ForwardingStorage) and seen < 8:
        storage = storage._backend
        seen += 1
    if isinstance(storage, JournalStorage) and isinstance(storage._backend, IciJournalBackend):
        return storage
    return None


def _ici_backend(storage: "BaseStorage") -> IciJournalBackend | None:
    journal = _ici_journal_storage(storage)
    return None if journal is None else journal._backend


#: The storage writes :class:`PodFollowerStorage` mirrors, exactly the
#: journal's op surface: each is one leader-side ``append_logs`` and
#: therefore one collective the follower must pace.
_POD_WRITE_METHODS: frozenset[str] = frozenset(
    {
        "create_new_study",
        "delete_study",
        "set_study_user_attr",
        "set_study_system_attr",
        "create_new_trial",
        "create_new_trials",
        "set_trial_param",
        "set_trial_state_values",
        "set_trial_intermediate_value",
        "set_trial_user_attr",
        "set_trial_system_attr",
    }
)


class PodFollowerStorage(_ForwardingStorage):
    """The non-leader face of the pod's lockstep trial sync.

    In the pod every rank runs the same ``optimize_sharded`` loop, but only
    rank 0 (the *leader*) may append journal ops: a create replayed once a
    rank would mint one trial a rank. This wrapper makes a follower's loop
    collective-count-identical to the leader's without double writes: every
    write call pops one (empty) ``exchange()``, pacing the collective the
    leader's ``append_logs`` runs, then derives its return value from the
    leader's op, now in the merged journal (a create's trial ids are the
    journal's newest; a claim CAS reads the claimed trial's merged state).
    Reads pass through to the merged replay state, identical on every rank.

    The contract this rests on: the follower runs the *same deterministic
    loop* as the leader (the same seeded sampler over the same merged
    history, the same batch shapes), so its k-th write corresponds to the
    leader's k-th append. A rank-asymmetric fault breaks that and surfaces
    as a collective mismatch or timeout, never as silent divergence;
    nondeterministic writers (the wall-clock-rate-limited health reporter)
    are suppressed for pod runs by :func:`optimize_sharded`.
    """

    def __init__(self, storage: "BaseStorage") -> None:
        # Accept exactly what _PodSync.detect accepts: the journal may sit
        # under forwarding decorators; reads keep flowing through the whole
        # chain, while the mirror reads the unwrapped journal's replay.
        journal = _ici_journal_storage(storage)
        if journal is None:
            raise ValueError(
                "PodFollowerStorage wraps a (possibly decorated) "
                "JournalStorage over an IciJournalBackend; got "
                f"{type(storage).__name__}."
            )
        super().__init__(storage)
        self._journal = journal
        self._ici = journal._backend

    def _forward(self, method: str, *args: Any, **kwargs: Any) -> Any:
        if method not in _POD_WRITE_METHODS:
            return super()._forward(method, *args, **kwargs)
        if method == "create_new_trials":
            n = kwargs.get("n", args[1] if len(args) > 1 else 0)
            if n <= 0:
                # The leader's zero-width create returns without an append:
                # there is no collective to pace, and an unpaired exchange
                # would leave this rank one round ahead.
                return []
        # One collective a mirrored write: the leader's append lands in the
        # merged journal during this exchange.
        self._ici.exchange()
        with self._journal._thread_lock:
            self._journal._sync()
            return self._derive(method, args, kwargs)

    def _derive(self, method: str, args: tuple, kwargs: dict) -> Any:
        replay = self._journal._replay
        if method == "create_new_study":
            return replay.next_study_id - 1
        if method == "create_new_trial":
            return replay.next_trial_id - 1
        if method == "create_new_trials":
            n = kwargs.get("n", args[1] if len(args) > 1 else 0)
            return list(range(replay.next_trial_id - n, replay.next_trial_id))
        if method == "set_trial_state_values":
            state = kwargs.get("state", args[1] if len(args) > 1 else None)
            if state == TrialState.RUNNING:
                # Claim CAS: under the single-writer contract the leader's
                # claim is the only contender, so the merged state says
                # whether it won.
                trial = replay._trial(args[0])
                return trial is not None and trial.state == TrialState.RUNNING
            return True
        return None


class _PodSync:
    """Batch-boundary exchange points for an ICI-journal study: one barrier
    collective closes every batch, so the lockstep ranks align a batch and
    the journal's round counter advances together."""

    def __init__(self, backend: IciJournalBackend) -> None:
        self._backend = backend

    @staticmethod
    def detect(study: "Study | None") -> "_PodSync | None":
        backend = None if study is None else _ici_backend(study._storage)
        return None if backend is None else _PodSync(backend)

    def barrier(self) -> None:
        with telemetry.span("shard.exchange"):
            self._backend.exchange()


# ------------------------------------------------------------------- executor


class ShardedBatchExecutor(ResilientBatchExecutor):
    """The :class:`ResilientBatchExecutor` with shard-granular containment
    and pod exchange points.

    Differences from the base class, each scoped so the degenerate
    ``{'trials': n, 'model': 1}`` mesh stays trial-for-trial identical to
    ``optimize_vectorized``:

    * a failed dispatch splits along **shard-group boundaries** first (see
      :meth:`_split_for_bisection`); binary bisection takes over only inside
      a single shard's rows;
    * per-dispatch ``shard.*`` device stats and per-shard throughput gauges
      (``shard.trials.t<k>.total``) feed the doctor's ``shard.imbalance``
      check;
    * with a :class:`_PodSync` attached, every rank runs the loop (the
      lockstep pod) and one barrier exchange closes every batch;
    * a ``ckpt:sharded`` ring marker is written at every batch boundary.
    """

    def __init__(
        self,
        study: "Study",
        objective: "VectorizedObjective",
        *,
        mesh: "DeviceMesh",
        batch_axis: str = "trials",
        pod: _PodSync | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(study, objective, mesh=mesh, batch_axis=batch_axis, **kwargs)
        self._n_shards = self._n_dev
        self._pod = pod
        if pod is not None:
            self._role = None  # the lockstep pod: every rank runs the whole loop
        # Row ownership of the current top-level batch: trial_id -> shard,
        # so bisected and halved re-dispatches still attribute their
        # throughput and quarantines to the right shard.
        self._shard_of: dict[int, int] = {}
        # Durable batch-boundary progress marker (ckpt:sharded ring). The seq
        # continues above any dead incarnation's; the peek and the counters
        # derive from merged-journal state and batch outcomes, so every
        # lockstep rank computes them alike.
        self._ckpt_seq = 0 if self._role == "follower" else (
            _ckpt.max_slot_seq(study._storage, study._study_id, "sharded") + 1
        )
        self._ckpt_batches = 0
        self._ckpt_advanced = 0

    # ------------------------------------------------------------- sharding

    def _rows_per_shard(self, b: int) -> int:
        """Rows each trials shard owns for a ``b``-wide batch (after the
        padding ``_eval`` applies)."""
        return max(1, -(-b // self._n_shards))

    def _shard_groups(self, trials: Sequence["Trial"]) -> list[list["Trial"]]:
        """The batch partitioned into the row groups each trials shard
        owns: contiguous rows, as :class:`~optuna_tpu_torch.parallel._mesh.
        MeshDispatch` lays them out."""
        rows = self._rows_per_shard(len(trials))
        return [
            list(trials[k * rows : (k + 1) * rows])
            for k in range(self._n_shards)
            if trials[k * rows : (k + 1) * rows]
        ]

    def _split_for_bisection(self, trials: list["Trial"]) -> list[list["Trial"]]:
        groups = self._shard_groups(trials)
        if len(groups) > 1:
            # Per-shard containment: the poison trial FAILs inside its own
            # shard group's re-dispatch; every other shard's rows are
            # salvaged whole.
            if device_stats.enabled():
                device_stats.harvest({"shard.contained_groups": len(groups)})
            _logger.warning(f"splitting the failed dispatch along its {len(groups)} shard groups (per-shard containment).")
            return groups
        return super()._split_for_bisection(trials)

    # ---------------------------------------------------------------- phases

    def _suggest_and_run(self, trials, proposals, ask_seconds: float) -> None:
        # Fresh row ownership a top-level batch: the dict stays bounded by
        # one batch and sub-dispatch attribution cannot leak across batches.
        rows = self._rows_per_shard(len(trials))
        self._shard_of = {trial._trial_id: i // rows for i, trial in enumerate(trials)}
        super()._suggest_and_run(trials, proposals, ask_seconds)

    def _eval(self, trials):
        values, finite = super()._eval(trials)
        b = len(trials)
        # Under 'clip' nothing is quarantined (every trial COMPLETEs with
        # nan_to_num values), so the stat stays 0 to agree with the trials'
        # terminal states.
        clip = self._non_finite == "clip"
        if device_stats.enabled():
            device_stats.harvest(
                {
                    "shard.width": self._rows_per_shard(b),
                    "shard.quarantined": 0 if clip else int(b - np.count_nonzero(finite[:b])),
                }
            )
        if telemetry.enabled():
            # Seed every shard that owned rows in this dispatch with 0, so a
            # shard whose rows are ALL quarantined still registers its
            # throughput gauge: a 0-throughput shard is exactly what the
            # doctor's shard.imbalance check must be able to see.
            per_shard: dict[int, int] = {self._shard_of.get(t._trial_id, 0): 0 for t in trials}
            for i, trial in enumerate(trials):
                if clip or bool(finite[i]):
                    per_shard[self._shard_of.get(trial._trial_id, 0)] += 1
            for shard, n_ok in per_shard.items():
                telemetry.add_gauge(f"shard.trials.t{shard}.total", float(n_ok))
        return values, finite

    def _run_one_batch(self, remaining: int) -> int:
        advanced = super()._run_one_batch(remaining)
        if self._pod is not None:
            # The exchange point: one group-wide collective closes every
            # batch, aligning the lockstep ranks and flushing the round.
            self._pod.barrier()
        # Durable batch-boundary checkpoint. Every pod rank makes the SAME
        # deterministic call: the leader appends the attr, and each
        # follower's PodFollowerStorage mirrors it by pacing one collective;
        # a leader-only call would leave the followers one exchange behind.
        self._ckpt_batches += 1
        self._ckpt_advanced += int(advanced)
        _ckpt.write_checkpoint(
            self._study._storage,
            self._study._study_id,
            "sharded",
            {"batch_idx": self._ckpt_batches, "trials_advanced": self._ckpt_advanced, "n_shards": self._n_shards},
            n_told=self._ckpt_advanced,
            seq=self._ckpt_seq,
        )
        self._ckpt_seq += 1
        return advanced


# ------------------------------------------------------------------ front door


def optimize_sharded(
    study: "Study | None",
    objective: "VectorizedObjective",
    n_trials: int,
    *,
    mesh: "DeviceMesh | None" = None,
    mesh_shape: Mapping[str, int] | None = None,
    batch_size: int | None = None,
    batch_axis: str = "trials",
    callbacks: Sequence[Callable] | None = None,
    non_finite: str = "fail",
    fallback: str | None = None,
    bisect_on_error: bool = True,
    retry_policy: "RetryPolicy | None" = None,
    dispatch_deadline_s: float | None = None,
    device: "str | torch.device | None" = None,
) -> None:
    """Run ``n_trials`` across a 2-D ``{'trials', 'model'}`` mesh,
    fault-tolerantly, with trial sync over the ICI journal in the pod.

    ``mesh`` (or ``mesh_shape``, handed to :func:`build_study_mesh` with
    ``device``) lays out the ranks: the packed batch is sharded along
    ``batch_axis`` and a :class:`ShardedObjective`'s model along its
    partition rules (a plain
    :class:`~optuna_tpu_torch.parallel.vectorized.VectorizedObjective`
    replicates across the ``model`` axis). ``device`` is where the packed
    parameters go (default: the mesh's device). The containment knobs
    mean what they mean for
    :func:`~optuna_tpu_torch.parallel.vectorized.optimize_vectorized`,
    operating at shard granularity (see :class:`ShardedBatchExecutor`).

    Every rank calls this alike (see the module docstring for the two
    modes). In the pod (an ICI-journal storage on several ranks), rank 0
    leads the storage writes and every other rank's writes are mirrored
    through :class:`PodFollowerStorage` for the run; elsewhere rank 0 alone
    runs the study and the others follow its dispatches, ignoring
    ``study``. On one rank both degrade to no-ops, and the run is trial for
    trial the one ``optimize_vectorized`` makes of the same seeded study.
    """
    if mesh is None:
        mesh = build_study_mesh(mesh_shape, device=device)
    if batch_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"batch_axis {batch_axis!r} is not a mesh axis {mesh.mesh_dim_names}.")
    pod = _PodSync.detect(study)
    multirank_pod = pod is not None and _mesh.world_size() > 1
    role = _mesh.role(mesh, pod=pod is not None)
    follower = multirank_pod and _mesh.rank() != 0 and not isinstance(study._storage, PodFollowerStorage)
    original_storage = None if study is None else study._storage
    prior_reporter = None if study is None else study.__dict__.get("_health_reporter")
    if follower:
        study._storage = PodFollowerStorage(original_storage)
    try:
        if multirank_pod:
            # Health publishes are wall-clock rate-limited and per worker: an
            # extra append on one rank would desynchronize the group-wide
            # exchange count. Reporting is suppressed for the run on every
            # rank.
            health.suppress(study)
        elif role != "follower":
            # Shard-aware worker identity for the doctor's fleet table (a
            # no-op unless the reporter is enabled; an attached reporter
            # keeps its id).
            health.attach(study, worker_id=mesh_worker_id(mesh))
        ShardedBatchExecutor(
            study,
            objective,
            mesh=mesh,
            batch_axis=batch_axis,
            pod=pod,
            batch_size=batch_size,
            callbacks=callbacks,
            non_finite=non_finite,
            fallback=fallback,
            bisect_on_error=bisect_on_error,
            retry_policy=retry_policy,
            dispatch_deadline_s=dispatch_deadline_s,
            device=device,
        ).run(n_trials)
    finally:
        if study is not None:
            study._storage = original_storage
            if multirank_pod:
                # Run-scoped suppression: restore whatever reporter state the
                # study had before (absent or a live reporter).
                if prior_reporter is None:
                    study.__dict__.pop("_health_reporter", None)
                else:
                    study.__dict__["_health_reporter"] = prior_reporter
