"""Quickest proof that optuna_tpu_torch runs its main path on an NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # also trace one more ask and scan chunk of each engine

Phases (any failure exits non-zero and prints no result line):

1. Build every CUDA kernel of the paths from ``optuna_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card at its
   path's shapes, and time it, its plain version and its bound: the Matérn
   Gram (K1) also against a float64 oracle, at ragged and categorical
   shapes, beside its launch and output-write floors; the dominance matrix
   (K2's compare) and the WFG node step (K3's device function, through its
   one-node kernel) bit for bit, also at frames of more than 16 objectives
   or 48 KB ((16, 17), (2048, 6)); the ranking kernels (K2 and its peeling
   loop on the NSGA-II path) rank for rank and front for front against the
   plain peeling loop, at (512, 2), (640, 5) with padding, (128, 3),
   (96, 40), a chain of 2048 fronts and (8192, 2); the WFG stack kernel (K3
   on the hypervolume path) bit for bit and node for node against the
   plain stack loop on the card, at the 512-point root, the fronts of
   32 and 64 that phase 17 times, and the (512, 17, 5) candidate roots of
   the HSSP's first greedy step (phase 21).
3. A small sparse reduction on the card against the same code on the CPU,
   and the device Sobol tier (``ops/qmc.py::sobol_sample_device``, plain
   torch) at (2048, 20): unshifted, SciPy's ``scramble=False`` points bit
   for bit; with a seeded generator, the numpy XOR of the shift it drew.
4. Exact engine: a GPSampler study on Hartmann-20D with 1000 seeded completed
   trials, then 3 GP asks.
5. Sparse engine: the same with 4000 trials and 8 GP asks, each through the
   SGPR program and its CUDA Matérn Gram (m = 256, N bucket 4096).
6. NSGA-II on ZDT1 (30 variables, population 256, 1024 trials): generations
   2 and 3 rank 512 trials through the ranking kernels. The same study on
   the CPU must be identical trial for trial.
7. The 5-objective hypervolume of a 512-point front and the leave-one-out
   contributions of its first 64 points through the WFG stack kernel (one
   launch each), against the host float64 oracle and the CPU (equal node
   counts).
8. The scan loop's sparse chunk program at a small size (d = 5, bucket 128,
   m_pad 16, chunk 8) on the card and on the CPU with the same inputs and
   draws: the fitted loss, the first proposal's LogEI, the chunk's fill,
   quarantines and first swap decision (K1 on the scan path against its
   plain version).
9. Scan, fresh: ``optimize_scan`` of the batched Hartmann-20D on a new
   study, 48 trials (16 startup, then exact chunks of 16 at buckets 32 and
   64), run twice with one seed: identical trial for trial.
10. Scan, exact: 960 seeded trials, then 64 trials in two exact chunks of 32
    at bucket 1024 (the cold fit, then a warm one).
11. Scan, sparse: 4000 seeded trials, then 64 trials in two SGPR chunks of 32
    at bucket 4096 with m_pad 256; K1 must launch once per chunk and once
    per inducing swap-in. Phases 9-11 print seconds per chunk, trials per
    second, the ``scan.chunk``/``scan.sync`` phase totals, the device stats
    and K1's launches; with ``--profile`` one more chunk of each engine is
    traced (kernels and host reads per step).
12. TPE (the single-objective default) on ``highdim_mixed`` (30 dims:
    15 floats, 5 log floats, 5 ints in [1, 64], 5 four-way categoricals),
    300 trials, univariate and then multivariate + group + constant liar,
    and on Branin (2 dims): each seeded study run twice on the card is
    identical; ms per trial over trials 50-299 on the card and in CPU
    torch (the same study with ``device="cpu"``); kernels an ask
    (profiler) at 30 dims, at 2 dims of the same types and at Branin's 2,
    which must not grow with the dims; synchronizing calls an ask (at most
    the one read).
13. Card against CPU at the ask level: 200 asks packed from each study's
    own history (univariate and multivariate), the same inputs and draws
    on both sides: the same choices, scores within 1e-3 and candidates
    within 2e-4 of a width; where a choice differs the best scores must be
    a near tie, and those asks are counted.
14. Hyperband with TPE on the card: every trial's bracket is the crc32
    rule's, and the sampler reads only its bracket's trials.
15. ``create_study()`` with no sampler samples with TPE on ``cuda``.
16. MOTPE (TPE on two objectives) on ZDT1, 30 variables, 576 trials: K2
    ranks the split on every ask from 512 complete trials and on none
    before; the first ranking equals the host's; the twin is identical.
17. Host and card times at the reference's routing thresholds (rank at
    256/512/1024 points, WFG at fronts of 32 and 64).
18. Threads on the card (``optimize(n_jobs=...)``): TPE on ``highdim_mixed``,
    300 trials at ``n_jobs`` 1 and 4 with ``MaxTrialsCallback`` and the
    retry callback attached (numbers dense, every trial COMPLETE and in its
    distributions, no two trials alike), and a threaded study whose
    objective raises once (exactly one retry clone, with ``failed_trial``
    and ``retry_history``); GPSampler on Hartmann-20D from 4000 seeded
    trials, one untimed warm-up ask, then warm sparse asks 2 sequential, 4
    at ``n_jobs=2``, 2 sequential (K1 at least 4 times from the worker
    threads); NSGA-II on ZDT1 at population
    256, 768 trials at ``n_jobs=4`` (K2 from the worker threads). ms per
    trial by host clock.
19. Wrapping samplers on the card: ``PartialFixedSampler({"x0": 0.5},
    GPSampler())`` from 1000 seeded trials, 2 asks on ``cuda``; Grid over
    3x3x4 stops at 36 trials, each point once; BruteForce enumerates 12
    leaves; ``GuardedSampler(TPESampler(seed=0))`` on Branin, 60 trials,
    identical to the unwrapped run; a NaN proposal degrades exactly trial
    30 (``sampler_fallback:relative``); a ``KernelBuildError`` from the
    wrapped sampler propagates, with no fallback.
20. The hypervolume slicing engine on the card through the routed
    functions: M = 3 at 1500 sphere points, M = 4 at 256, the leave-one-out
    at M = 3 over 128 points, against the host float64 oracle and the CPU.
21. The device HSSP at ``bench.py::run_hv_selection``'s shapes (512
    ``RandomState(0)`` uniform points, M = 5, ``ones(5)``, k = 16): K3 must
    launch exactly 16 times (one a greedy step); the picks equal the CPU's
    (the plain stack loop) and the host lazy greedy's, or part only at a
    near tie; the picks' hypervolume within 1e-3 of float64. Then M = 3 at
    256 points through the slicing scorer (no launch).
22. NSGA-III on ZDT1 (population 256, 1024 trials) on the card and the CPU:
    identical trial for trial; generations 2 and 3 rank 512 trials through
    K2.
23. MOTPE on three-objective DTLZ2 (12 variables) on the card until the
    split's HSSP has taken the device route 5 times (the first rank reaches
    128 points); how many trials that took.
24. CMA-ES, BASELINE.md config #3: ``CmaEsSampler(seed=0, popsize=40)`` on
    50-D Rastrigin, 2000 trials (the config's 5000 cut for time), twice on
    the card (identical) and once on the CPU; ms per trial over trials
    500-1999, kernels and synchronizing calls of a generation; then
    ``use_separable_cma``, ``lr_adapt``, ``with_margin`` (int/float) and
    IPOP for 200 trials each on the card.
25. GP config #2 as ``bench.py`` runs it, ``GPSampler(seed=0,
    speculative_chain=8)`` on Hartmann-20D: 32 trials from 960 seeded ones
    (4 exact chain dispatches, at 960, 968, 976 and 984 trials, all at
    bucket 1024), 16 from 4000 (2 sparse dispatches, K1 exactly once each); ms per
    trial beside phases 4 and 5's per-trial asks; a batch of 8
    (``sample_relative_batch``) at each size: 8 points in the box, not all
    one (the reference's test), with the distinct ones counted.
26. Running trials (qLogEI from worker threads): ``n_jobs`` 2 and 4 from
    1000 seeded trials (4 and 6 trials), with an objective slower than an ask (0.2 s, then
    held while an ask is in flight): at least asks less workers take
    ``_build_qlogei`` (a script-side wrap), all COMPLETE; then 1 ask from
    1000 and 1 from 4000 beside a RUNNING trial, K1 once an ask from 4000
    (the sparse host fit).
27. Constraints: Hartmann-20D with ``sum(x) - 10 <= 0`` through
    ``constraints_func``; 1 ask from 1000 seeded trials with constraint
    attrs, 1 from 4000 with K1 exactly 2 an ask (objective and constraint).
28. LogEHVI: ZDT1 (30 variables) 2 asks from 300 seeded trials, 3-objective
    DTLZ2 (12 variables) 2 asks from 200; the box count, s an ask, the
    kernels (and copies) of one more ask and the synchronizing calls of
    another, K1 exactly 0; one ask on the card and one on the CPU from the
    same 64 seeded trials and seed: proposals within 1e-3 (normalized), or
    a near tie of LogEHVI.

29. BASELINE config #5 as ``bench.py::run_ours_mlp_vectorized`` runs it:
    ``bench.py::_mlp_problem``'s data and weights (``RandomState(0)``, 256
    x 784 inputs, 10 classes, hidden 32), a batched objective of 10 SGD
    steps from ``base * init_scale`` at rate ``lr`` (``models.mlp.
    train_scaled_batch``), ``TPESampler(seed=0, multivariate=True,
    constant_liar=True, n_startup_trials=10)``, batches of 256 through
    ``optimize_vectorized``: 256 warm-up trials, then 2048 timed, once (two
    seeded runs of this index-loss path are not held to each other; phase
    36(a)'s twins hold two seeded runs of the same trainer on the one-hot
    loss to each other). Trials/s (host clock), one warm batch's device time
    (CUDA events) and GFLOP/s by ``bench.py:1157-1174``'s count,
    the device's busy share over two more traced batches, the best value;
    every trial COMPLETE inside its distributions; the executor's one
    synchronizing call a batch; the last batch on the card against CPU
    torch in float64, within 1e-3 (relative) plus twice CPU float32's own
    error, trial by trial.
30. The executor's containment on the card around config #5's objective
    (``RandomSampler``, batches of 64): NaN at three positions under
    ``non_finite`` ``fail``, ``raise`` and ``clip``; a persistent poison
    trial (it FAILs alone, the other 63 COMPLETE); a real
    ``torch.OutOfMemoryError`` of the card at 32 trials a dispatch (each
    trial asks for 0.6 / 16 of the free memory), which must halve until it
    fits and regrow after two clean batches, with the
    fault kit's stand-in's ``dispatch_widths`` on the same schedule; a hung
    dispatch under a 1 s deadline, salvaged by bisection. No case leaves a
    trial RUNNING.
31. GPSampler on Hartmann-20D (``hartmann20_torch``) from 4000 seeded
    trials, two batches of 8 through ``optimize_vectorized``: K1 exactly once
    a batch (one sparse ``sample_relative_batch``), every trial COMPLETE.
32. Preempt and resume config #2's scan study over durable storages: the
    1100 COMPLETE trials of :func:`history_trials` written into a
    journal file (``JournalStorage(JournalFileBackend)``) and into sqlite
    (``create_study(storage="sqlite:///...")``) in a temporary directory;
    ``optimize_scan`` of 96 trials (``sync_every`` 32, seed 0, ``n_exact_max``
    1024, m = 256: every chunk SGPR at bucket 2048) on the journal study,
    killed at its 45th tell (``FaultInjectorStorage``'s
    ``SimulatedWorkerDeath``, inside the second chunk's sync); the study
    reloaded from the file through a new storage object and resumed
    (``resume=True``); the uninterrupted twin on the sqlite study. Exactly
    96 budget-consuming tells, nothing RUNNING, no op token told twice,
    ``checkpoint.restore`` once and ``checkpoint.fallback`` never, the
    resumed trials equal to the twin's (params and values, trial for
    trial), and K1 exactly once a chunk boundary and once a swap-in over
    the three runs (the killed run's third chunk, dispatched but never
    synced, swaps as the resumed run's last chunk does). Seconds of the
    seeding, of each run and of the resume's restore.
33. Analysis and early stopping over the 1100 Hartmann-20D trials of
    :func:`history_trials` (config #2's space at full width, past
    ``N_EXACT_MAX``): fANOVA, MDI (64 trees each) and PED-ANOVA through
    ``get_param_importances`` on the card and with ``device="cpu"``
    (PED-ANOVA identical, fANOVA and MDI within 0.02 with the same top
    parameter), ms of each; the forest alone on the card (profiler: kernels,
    host reads) and on the CPU, and fANOVA's host variance apart from it;
    ``RegretBoundEvaluator`` and ``EMMREvaluator`` on the card and the CPU
    (within 1e-3 of the score's sd), K1 exactly once a sparse fit; a GP
    study with ``TerminatorCallback(Terminator(BestValueStagnationEvaluator(3),
    StaticErrorEvaluator(0)))`` stopping at the trial the stagnation rule
    names; 3 GP trials from the 1100 with the default
    ``TerminatorCallback()`` (K1 once an ask and once a callback, the
    callback's seconds a trial); ``plot_hypervolume_history`` on a
    5-objective DTLZ2 study of 96 ``RandomSampler`` trials, K3 exactly once
    a prefix whose front holds 32 points, every value within 1e-3 of host
    float64; ``plot_param_importances``, ``plot_optimization_history`` and
    ``plot_terminator_improvement`` (30 trials) as JSON-able dicts; one
    ``python -m optuna_tpu_torch.cli`` ask (TPE on the card, past its
    startup trials) and tell over sqlite.

34. The doctor and the autopilot on config #2's scan: the 1100 trials of
    :func:`history_trials` in sqlite; ``optimize_scan`` of 160 trials
    (``sync_every`` 32, seed 0, ``n_exact_max`` 1024, ``n_inducing`` 128:
    five SGPR chunks at bucket 2048) with telemetry, the flight recorder, the
    health reporter (``interval_s=0``) and the autopilot in ``act`` mode
    (``sparse_heldout_err_warn`` 0, ``rollback_after`` 64, an hour's
    cooldown): ``gp.densify`` decided once at chunk 0's sync (chunk 1 is
    already dispatched), K1's inducing operand 128 rows in chunks 0-1 and
    256 in chunks 2-3, the rollback verdict at chunk 2's sync (does chunk
    2's held-out error at m = 256 fall below chunk 0's?) and chunk 4 at the
    verdict's width; the verdict in the control dict, the sqlite mirror and
    ``optuna-tpu-torch doctor`` / ``autopilot`` (two processes); chunk 2
    under ``_tracing.trace``, its K1 kernels inside ``scan.chunk``; the
    Chrome trace, the exposition (the reference's grammar) and
    ``serve_metrics`` on a loopback port; observe, autopilot-off and
    all-hooks-off twins of one SGPR chunk identical trial for trial, run in
    turns (off, observe, autopilot off, off) for the seconds an SGPR chunk
    with every hook on and off; ``AutopilotChaosPlan``
    through ``optimize_vectorized(autopilot=...)`` on the card; the device
    policy's round trip, which must keep small kernels on the card.

35. Config #2's GP served from the card: a ``SuggestService`` whose hub
    sampler is ``GPSampler(seed=0)``, reached through the server's
    grpc-free request dispatcher (wire codec, op tokens: ``bench.py
    --loop=serve --transport=handler``), over the 1100 trials of
    :func:`history_trials` (every dispatch SGPR, K1 once). (a) One
    ``ThinClientSampler`` with ``ready_ahead=0``: 3 trials identical to a
    local ``GPSampler(seed=0)`` study's, K1 once an ask on each side.
    (b) 8 client threads x 2 asks, ``max_coalesce=8``, ``ready_ahead=8``,
    ``invalidate_after=8``, a 50 ms coalesce window, the shed ladder above
    8: widest dispatch >= 2, no shed, every trial COMPLETE and served (no
    fallback attr, no local independent answer), K1 once a coalesced
    dispatch and once a refill; ready-queue hits and misses, the client's
    ``service_ask`` p50/p99, ms a served trial; then a third round (the
    ready queue emptied, so it coalesces as the first did) under the
    profiler for the device's busy share. (c) Two hubs (``FakeHubFleet``) over one sqlite file,
    ``checkpoint_every=4``: a ``FleetClient`` thin client runs 8 trials on
    the owner, one answer dropped after it committed (the redial replays
    it: no second dispatch); the owner killed, 2 more trials through the
    survivor: the lease epoch bumped to it, one ``checkpoint.warm_load``,
    and the cold first dispatch beside the warm one after the re-home.

36. The sharded tier. (a) Config #5's sharded MLP (``bench.py::
    _sharded_mlp_objective`` in torch: ``models.mlp.train_scaled_batch``
    with ``cross_entropy_onehot``, 10 SGD steps) as a ``ShardedObjective`` with the
    rules ``w1 -> (None, "model")``, ``b1 -> ("model",)``, ``w2 -> ("model",
    None)``, ``.* -> ()``, its model as ``DTensor`` s on a 1 x 1 mesh of the
    card (NCCL on a one-rank ``HashStore`` group): ``TPESampler(seed=0,
    multivariate=True, constant_liar=True, n_startup_trials=10)``, 256
    warm-up and 512 timed trials in batches of 256 through
    ``optimize_sharded``, and its twin through ``optimize_vectorized`` of the
    same function on plain tensors: identical trial for trial (trials,
    states, params, values). Trials/s of both, the ``DTensor`` overhead (the
    sharded run's seconds less the twin's), the busy share over one more
    warm batch, the placements and local shapes of ``w1``/``b1``/``w2``.
    (b) A two-rank pod on this host: two processes started with the script
    (gloo over a file, both evaluating on ``cuda:0``, since NCCL refuses two
    ranks on one card), mesh ``{'trials': 2, 'model': 1}`` over
    ``JournalStorage(IciJournalBackend())`` in the pod's lockstep;
    ``RandomSampler(seed=0)``, 4 batches of 16 of config #5's MLP, one
    poison row in shard t1's rows of batch 2 (row 11). The first failed
    dispatch splits into the two shard groups; t0's 8 trials complete in one
    re-dispatch and the bisection stays inside t1's rows; only the poison
    trial FAILs, every other trial COMPLETEs once; both ranks' merged logs
    and studies are equal; the leader's study equals a one-process twin on
    the card at 1 x 1 (params and states exactly, values within 1e-5: the
    ranks multiply 8 rows where the twin multiplies 16). No kernel of the
    repo launches, in this process or the pod's.

The longest CPU twins (phase 7's hypervolume, phase 21's M = 5 HSSP,
phase 28's two LogEHVI asks and phase 33's terminator evaluators, each with
``device="cpu"``) run in one helper process (:class:`CpuTwins`, niced,
never touching the card) from the start, beside the card's
phases; each phase holds the card's result against its twin when it gets
there. Their seconds are the helper's, beside the card's work.

The kernel launch counters are set to 0 just before each path (phases 4-5,
6, 7, 9-11, 12-15, 16, 18-19, 20-21, 22, 23, 24, 25-28, 29-30, 31, 32, 33, 34, 35, 36) and
read just after it; every kernel must have launched on its path, the
single-objective TPE, CMA-ES and config #5 phases none, K3 exactly twice on
phase 7 and 16 times on phase 21, K1 exactly twice on phase 31 and once a
chunk and a swap-in on phase 32, K1 and K3 exactly as counted on phase 33
(no other kernel), K1 exactly as its spy counts on phase 34, K1 once a
hub dispatch on phase 35, no kernel on phase 36, and the
dominance-matrix and one-node WFG kernels not at all (the ranking
kernels rank, the stack kernel runs every node). The counters are raised
under a lock in each wrapper, so the threaded launches of phase 18 count
exactly. The line before the last
is the kernel table as JSON (every kernel, the two check kernels with their
0 launches); the last line is the device summary.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# The kernels: wrapper module, its launch counter, source, TPU kernel
# replaced. The dominance-matrix kernel and the one-node WFG kernel are
# checks and no path launches them; the ranking kernels run K2 (with the
# reference's peeling loop, optuna_tpu/ops/pareto.py:56) on the NSGA-II
# path, the stack kernel K3 on the hypervolume path.
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
        "name": "nds_rank",
        "module": "optuna_tpu_torch.ops.kernels.nds",
        "counter": "RANK_LAUNCHES",
        "source": "optuna_tpu_torch/ops/kernels/csrc/dominance.cu",
        "replaces": "optuna_tpu/ops/pallas/nds.py:24",
    },
    {
        "name": "wfg_limit_filter",
        "module": "optuna_tpu_torch.ops.kernels.wfg",
        "source": "optuna_tpu_torch/ops/kernels/csrc/wfg_limit_filter.cu",
        "replaces": "optuna_tpu/ops/pallas/wfg.py:40",
    },
    {
        "name": "wfg_stack",
        "module": "optuna_tpu_torch.ops.kernels.wfg",
        "counter": "STACK_LAUNCHES",
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
SCAN_FRESH_TRIALS = 48  # 16 startup trials, then chunks of 16 at buckets 32 and 64
SCAN_LOSS_RTOL = 1e-4  # scan chunk card vs CPU: the fitted loss (tests/test_torch_scan_parity.py)
SCAN_LOGEI_ATOL = 1e-3  # ... and the LogEI of the first proposals, the same points on both sides
TPE_TRIALS, TPE_WARMUP = 300, 50  # bench.py --config tpe_highdim: 50 warm-up trials, then the timed window
MOTPE_TRIALS = 576  # two-objective TPE on ZDT1: asks from trial 512 on rank through K2 (1024 before PR 9, 640
#                    before phase 34)
TPE_ASKS = 200  # asks packed from a study's own history, card against CPU
# Card against CPU at the ask level, as measured on an H100 (PERF.md, Findings):
# scores 1.81e-4 apart (of max(1, |score|)) and candidates 6.2e-5 of a width,
# from CUDA's float32 ndtri/log_ndtr and sums in another order.
TPE_SCORE_TOL = 1e-3
TPE_CAND_TOL = 2e-4


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
    sources = list(dict.fromkeys(os.path.basename(k["source"]) for k in KERNELS))
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
    name: str, shape, fn, plain_fn, n_bytes: int, n_ops: int, max_abs_err: float, unit: str = "compares",
    extra: str = "",
) -> dict:
    """Time a kernel and its plain version (device time from a CUDA graph,
    and per call with host overhead), print them beside the bound (and
    ``extra``), and return the kernel's row of the table."""
    ms = graph_ms(fn)
    plain_ms = graph_ms(plain_fn)
    call_ms = cuda_ms(fn)
    plain_call_ms = cuda_ms(plain_fn)
    row = kernel_row(name, max_abs_err, ms, plain_ms, n_bytes, n_ops)
    print(
        f"{name} time at {shape}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms "
        f"(device time, CUDA graph); per call with host overhead: kernel {call_ms:.4f} ms, "
        f"plain {plain_call_ms:.4f} ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
        f"{n_bytes} B, {n_ops} {unit}){extra}; no single PyTorch call computes this function"
    )
    return row


#: The host-side CUDA calls that put one kernel or one copy on the card.
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
})


def device_kernels(fn, calls: int = 10) -> int:
    """Kernels (and copies) one call of ``fn`` puts on the card: the launch and
    copy calls the host makes, as ``torch.profiler`` records them on the host
    side, over ``calls`` calls, divided by ``calls`` and rounded. The host's
    calls are recorded synchronously; the device's activity records can miss
    the first few of a trace, by a number that follows the process's state."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launched = sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CUDA and e.key in LAUNCH_CALLS)
    return round(launched / calls)


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
    per_call = device_kernels(lambda: matern.matern52_gram(*args))
    if per_call > 1:
        fail(f"matern52_gram: one call ran {per_call} kernels on the card, expected 1")
    # Yardsticks the port never calls: the kernel on one element (the
    # launch floor) and writing the output once.
    tiny = matern_inputs(1, 1, d, 0, seed=1, device=device)
    launch_floor = graph_ms(lambda: matern.matern52_gram(*tiny))
    write_floor = graph_ms(lambda: torch.empty(n1, n2, device=device).zero_())
    return print_times(
        "matern52_gram", (n1, n2, d), lambda: matern.matern52_gram(*args),
        lambda: matern.matern52_gram_plain(*args),
        n_bytes=4 * (n1 * d + n2 * d + d + 1 + n2 * n1) + d,  # inputs read once, output written once
        n_ops=n1 * n2 * (3 * d + 9),  # sub, mul, fma per dim; sqrt, exp and 7 flops per element
        max_abs_err=worst_plain, unit="flops",
        extra=(
            f"; floors (device time, CUDA graph): launch {launch_floor:.5f} ms (the kernel at (1, 1, {d})), "
            f"write {write_floor:.5f} ms (torch.empty({n1}, {n2}).zero_()); {per_call} kernel(s) a call"
        ),
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


def rank_cases(device) -> list:
    """``(label, values, mask)`` of the ranking checks: ordinals with ties,
    duplicate rows and padded rows as ``non_domination_rank_np`` makes them,
    and a chain of 2048 fronts in shuffled row order."""
    import torch

    cases = []
    for label, n, m, n_pad in (
        ("main path", 512, 2, 512), ("ties, duplicates, padding", 600, 5, 640), ("one tile", 128, 3, 128),
        ("40 objectives", 96, 40, 96), ("large N", 8192, 2, 8192),
    ):
        mask = torch.zeros(n_pad, device=device)
        mask[:n] = 1.0
        cases.append((label, nds_inputs(n, m, n_pad, seed=n + m, device=device), mask))
    order = np.random.default_rng(7).permutation(2048).astype(np.float32)
    chain = torch.as_tensor(np.stack([order, order], axis=1), device=device)
    cases.insert(4, ("chain of 2048 fronts", chain, torch.ones(2048, device=device)))
    return cases


def phase_nds_rank(device) -> dict:
    """The ranking kernels against the plain peeling loop, both on the card:
    the same ranks and front count at every case, and their times."""
    import torch

    from optuna_tpu_torch.ops.kernels import nds

    main = None
    for label, v, mask in rank_cases(device):
        n, m = v.shape
        out = nds.rank_fronts(v, mask)
        torch.cuda.synchronize()
        plain = nds.rank_fronts_plain(v, mask)
        same = torch.equal(out, plain)
        fronts = int(out[n])
        ms = graph_ms(lambda: nds.rank_fronts(v, mask))
        plain_ms = cuda_ms(lambda: nds.rank_fronts_plain(v, mask), reps=5)
        n_bytes, n_ops = 4 * (n * m + n) + 4 * (n + 1), 2 * m * n * n  # values and mask in, ranks and count out
        row = kernel_row("nds_rank", 0.0, ms, plain_ms, n_bytes, n_ops)
        route = "shared" if nds.ranks_in_shared(n, device) else "global"
        print(
            f"nds_rank {label} ({n}, {m}): bit-exact {same}, {fronts} fronts (plain {int(plain[n])}), "
            f"matrix in {route} memory; kernel {ms:.5f} ms (device time, CUDA graph, 2 launches), "
            f"{ms / max(fronts, 1) * 1e3:.3f} us a front; plain loop {plain_ms:.3f} ms (CUDA events, "
            f"host syncs inside); bound {row['bound_ms']:.7f} ms ({row['bound_by']}: {n_bytes} B, {n_ops} compares)"
        )
        if not same:
            fail(f"nds_rank {label}: the kernels differ from the plain peeling loop")
        if main is None:
            main = (v, mask, row)
    v, mask, row = main
    per_call = device_kernels(lambda: nds.rank_fronts(v, mask))
    torch.cuda.set_sync_debug_mode("error")  # any host sync inside the wrapper raises
    try:
        nds.rank_fronts(v, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    call_ms = cuda_ms(lambda: nds.rank_fronts(v, mask))
    print(
        f"nds_rank at {tuple(v.shape)}: {per_call} kernel(s) and no host sync a ranking; per call with host "
        f"overhead {call_ms:.4f} ms; the fronts are one dependent chain of steps, so the kernel is bound by "
        f"the latency of a step, not by its bound; no single PyTorch call computes this function"
    )
    if per_call > 2:
        fail(f"nds_rank: one ranking ran {per_call} kernels on the card, expected at most 2")
    return row


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

    for n, m in ((128, 5), (512, 5), (64, 6), (1024, 8), (16, 17), (2048, 6)):
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
    n_el = int(frame[2].sum())  # the kernel compares the eligible rows only
    return print_times(
        "wfg_limit_filter", (n, m), lambda: wfg.limit_and_filter(*frame), lambda: wfg.limit_and_filter_plain(*frame),
        n_bytes=4 * (2 * n * m + 2 * m) + 2 * n, n_ops=2 * m * n_el * n_el + n_el * m, max_abs_err=0.0,
    )


def unit_front(k: int | None = None) -> np.ndarray:
    """The main path's 5-objective front (the Pareto points of 512
    ``RandomState(0)`` points), or its first ``k`` points, mapped into the
    unit box as ``compute_hypervolume`` maps it before the device route."""
    from optuna_tpu_torch.hypervolume import _normalize_for_device
    from optuna_tpu_torch.hypervolume.wfg import _pareto_filter

    front = _pareto_filter(np.random.RandomState(0).uniform(0.0, 1.0, size=(512, 5)))
    unit, _, _ = _normalize_for_device(front if k is None else front[:k], np.ones(5))
    return unit


def wfg_roots(unit: np.ndarray, device):
    """The sorted root frame ``(pts0 (1, N, M), m0, ref)`` that
    ``hypervolume_wfg_nd`` hands to ``wfg_stack`` for ``unit``."""
    import torch

    from optuna_tpu_torch.ops import wfg

    pts, mask = wfg._padded(unit, np.ones(unit.shape[1]), device)
    ref = torch.ones(unit.shape[1], device=device)
    pts0, m0 = wfg._roots(pts[None], ref, mask[None])
    return pts0, m0, ref


def stack_work(pts0, m0) -> tuple[int, int]:
    """``(nodes, compares)`` of the WFG stack from one sorted root, walked on
    the host in numpy. A node with a pivot clamps its ``n_el`` eligible rows
    (``n_el * M``) and compares them pairwise in every objective, ``leq``
    and ``strict`` (``2 * M * n_el**2``); a node without one (a pop)
    compares nothing. This is the work the stack kernel does on this data."""
    pts, msk = pts0[0].cpu().numpy(), m0[0].cpu().numpy()
    n, m = pts.shape
    idx = np.arange(n)
    stack = [[pts, msk, 0]]
    nodes = compares = 0
    while stack:
        nodes += 1
        top = stack[-1]
        pts, msk, cur = top
        rest = np.flatnonzero(msk[cur:])
        if len(rest) == 0:
            stack.pop()
            continue
        nxt = cur + int(rest[0])
        top[2] = nxt + 1
        rows = np.flatnonzero(msk & (idx > nxt))
        k = len(rows)
        compares += 2 * m * k * k + k * m
        child = np.maximum(pts, pts[nxt])
        eff = child[rows]
        leq = np.all(eff[:, None, :] <= eff[None, :, :], axis=2)
        strict = np.any(eff[:, None, :] < eff[None, :, :], axis=2)
        earlier = np.arange(k)[:, None] < np.arange(k)[None, :]
        kept = rows[~np.any(leq & (strict | earlier), axis=0)]
        if len(kept) > 1:
            child_msk = np.zeros(n, bool)
            child_msk[kept] = True
            stack.append([child, child_msk, 0])
    return nodes, compares


def phase_wfg_stack(device) -> dict:
    """The stack kernel against the plain stack loop, both on the card: the
    same bits and the same node count at the 512-point root and at the
    fronts of 32 and 64 that phase 17 times; then its time at the root."""
    import torch

    from optuna_tpu_torch.ops.kernels import wfg

    main = None
    for label, k in (("main path, 512-point front", None), ("front 32", 32), ("front 64", 64)):
        roots = wfg_roots(unit_front(k), device)
        acc, nodes = wfg.wfg_stack(*roots)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_acc, plain_nodes = wfg.wfg_stack_plain(*roots)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        same = torch.equal(acc, plain_acc) and torch.equal(nodes, plain_nodes)
        print(
            f"wfg_stack {label} {tuple(roots[0].shape)}: bit-exact {same}, {int(nodes[0])} nodes "
            f"(plain {int(plain_nodes[0])}), hypervolume {float(acc[0]):.9f}"
        )
        if not same:
            fail(f"wfg_stack {label}: the kernel differs from the plain stack loop")
        if k is None:
            main = (roots, int(nodes[0]), plain_s)
    roots, nodes, plain_s = main
    _, n, m = roots[0].shape
    walk_nodes, compares = stack_work(*roots[:2])
    if walk_nodes != nodes:
        fail(f"wfg_stack: the host walk took {walk_nodes} nodes, the kernel {nodes}")
    ms = cuda_ms(lambda: wfg.wfg_stack(*roots), reps=5)
    row = kernel_row(
        "wfg_stack", 0.0, ms, plain_s * 1e3,
        n_bytes=4 * (n * m + m) + n + 4 + 8,  # root, mask and ref read once; acc and nodes written once
        n_ops=compares,
    )
    print(
        f"wfg_stack time at {tuple(roots[0].shape)}: kernel {ms:.3f} ms ({ms / nodes * 1e3:.3f} us per node; "
        f"CUDA events around one call, median of 5), plain stack loop on the card {plain_s * 1e3:.1f} ms "
        f"(host clock, one run); bound {row['bound_ms']:.7f} ms ({row['bound_by']}: {compares} compares, "
        f"the sum over the {nodes} nodes of 2*M*n_el^2 + n_el*M for the n_el eligible rows each compares; "
        f"the nodes form one dependent chain, so the kernel is bound by the latency of a node, not by this); "
        f"no single PyTorch call computes this function"
    )
    return row


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


def phase_hv(twins: CpuTwins) -> float:
    import torch

    from optuna_tpu_torch.hypervolume import compute_hypervolume, loo_contributions
    from optuna_tpu_torch.hypervolume.wfg import _compute_hv_recursive, _pareto_filter
    from optuna_tpu_torch.ops import wfg
    from optuna_tpu_torch.ops.kernels import wfg as kernels

    front, ref = hv_front()
    wfg.reset_stats()
    before = kernels.STACK_LAUNCHES
    t0 = time.perf_counter()
    hv = compute_hypervolume(front, ref)
    torch.cuda.synchronize()
    card_s, stats, launches = time.perf_counter() - t0, dict(wfg.STATS), kernels.STACK_LAUNCHES - before
    t0 = time.perf_counter()
    pareto = _pareto_filter(front)
    oracle = _compute_hv_recursive(pareto, ref)
    oracle_s = time.perf_counter() - t0
    cpu_hv, cpu_s, cpu_stats = twins.get("hv")
    e_f64 = abs(hv - oracle) / oracle
    e_cpu = abs(hv - cpu_hv) / abs(cpu_hv)
    print(
        f"hypervolume M=5, 512 points (front {len(pareto)}, bucket {wfg._pad_bucket(len(pareto))}): card {hv:.9f} "
        f"in {card_s:.4f} s ({stats['nodes']} stack iterations, {launches} stack launch(es), "
        f"{stats['syncs']} host sync(s)); CPU {cpu_hv:.9f} in {cpu_s:.3f} s ({cpu_stats['nodes']} stack "
        f"iterations; the helper process); host f64 oracle {oracle:.9f} in {oracle_s:.3f} s; card faster than the oracle: "
        f"{card_s < oracle_s}; rel err vs f64 {e_f64:.3e} (tolerance {HV_TOL_F64}), "
        f"vs CPU {e_cpu:.3e} (tolerance {HV_TOL_CPU})"
    )
    if not (math.isfinite(hv) and e_f64 <= HV_TOL_F64 and e_cpu <= HV_TOL_CPU):
        fail("5-objective hypervolume disagrees with the f64 oracle or the CPU")
    if stats["nodes"] != cpu_stats["nodes"]:
        fail(f"5-objective hypervolume: {stats['nodes']} stack iterations on the card, {cpu_stats['nodes']} on the CPU")
    if launches != 1:
        fail(f"5-objective hypervolume: the stack kernel launched {launches} times, expected 1")

    sub = front[:64]
    t0 = time.perf_counter()
    want = host_loo(sub, ref)
    oracle_s = time.perf_counter() - t0
    if oracle_s > 60.0:
        print(f"host leave-one-out oracle took {oracle_s:.1f} s at 64 points: using the first 32")
        sub = front[:32]
        want = host_loo(sub, ref)
    wfg.reset_stats()
    before = kernels.STACK_LAUNCHES
    t0 = time.perf_counter()
    got = loo_contributions(sub, ref)
    torch.cuda.synchronize()
    loo_s = time.perf_counter() - t0
    launches = kernels.STACK_LAUNCHES - before
    total = _compute_hv_recursive(_pareto_filter(sub), ref)
    err = float(np.max(np.abs(got - want))) / total
    print(
        f"leave-one-out M=5, {len(sub)} points: card {loo_s:.4f} s ({wfg.STATS['nodes']} stack iterations, "
        f"{launches} stack launch(es), {wfg.STATS['syncs']} host sync(s)); host oracle {oracle_s:.3f} s; "
        f"max |card - oracle| / total {err:.3e} (tolerance {LOO_TOL}); {int(np.sum(got > 0))} positive"
    )
    if not (np.isfinite(got).all() and err <= LOO_TOL):
        fail("leave-one-out contributions disagree with the host oracle")
    if launches != 1:
        fail(f"leave-one-out: the stack kernel launched {launches} times, expected 1")
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
        unit = unit_front(k)
        host_ms = best_of(lambda: _compute_hv_recursive(pts, np.ones(5)), reps=1)
        card_ms = best_of(lambda: hypervolume_wfg_nd(unit, np.ones(5)), reps=1)
        parts.append(f"WFG M=5 front {k}: host {host_ms:.1f} ms, card {card_ms:.2f} ms")
    print("routing thresholds (TPU-measured, kept; rank best of 3 calls, WFG one call a side): " + "; ".join(parts))


def history_trials(n_history: int, seed: int = 0, constraint: bool = False) -> list:
    """``n_history`` COMPLETE Hartmann-20D trials (uniform points from
    ``default_rng(seed)``); with ``constraint`` each carries the constraint
    attrs of :func:`sum_constraint`."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.distributions import FloatDistribution
    from optuna_tpu_torch.models.benchmarks import hartmann6_np

    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n_history, 20))
    values = hartmann6_np(X)
    dists = {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(20)}
    return [
        ot.create_trial(
            params={f"x{i}": float(row[i]) for i in range(20)}, distributions=dists, value=float(v),
            system_attrs={"constraints": (float(row.sum()) - 10.0,)} if constraint else None,
        )
        for row, v in zip(X, values)
    ]


def seeded_study(n_history: int, seed: int = 0, constraint: bool = False, **sampler_kwargs):
    """A Hartmann-20D GPSampler study holding :func:`history_trials`."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import GPSampler

    study = ot.create_study(sampler=GPSampler(seed=seed, **sampler_kwargs))
    study.add_trials(history_trials(n_history, seed, constraint))
    return study


def device_busy(prof) -> tuple[float, int]:
    """From a finished ``torch.profiler`` run: the device's busy ms and kernel
    count, summed over the device-side events only (an operator's row repeats
    its kernels' time, so summing every row counts each kernel twice). The
    port's ``record_function`` ranges (``telemetry.trace_name``, such as the
    scan loop's ``scan.chunk``) also show as device-side events spanning all
    inside them; they are left out. Read from the profiler's raw events:
    ``key_averages`` first builds a Python object an event, minutes for a
    served study's ~600k kernels."""
    from torch.autograd import DeviceType

    busy_ns = count = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.name().startswith("optuna_tpu_torch."):
            busy_ns += e.duration_ns()
            count += 1
    return busy_ns / 1e6, count


def profiled(label: str, fn) -> tuple[float, float, int, int, int]:
    """Run ``fn`` under torch.profiler; print the device's busy share, the
    host reads (device-to-host copies, stream syncs) and the top operators,
    write the full table to the output directory, and return the wall ms,
    the busy ms, the kernel count and the two host-read counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    busy_ms, kernels = device_busy(prof)
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))  # noqa: E731
    ops = sorted((e for e in events if e.device_type != DeviceType.CUDA), key=dev, reverse=True)
    dtoh = sum(e.count for e in events if "DtoH" in e.key)
    syncs = sum(e.count for e in events if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    print(
        f"profile {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {kernels} kernels, {dtoh} device-to-host copies, {syncs} stream "
        "syncs; top: " + "; ".join(f"{e.key[:48]} x{e.count} {dev(e) / 1e3:.2f} ms" for e in ops[:8])
    )
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"profile_{label.replace(' ', '_')}.txt"), "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    return wall_ms, busy_ms, kernels, dtoh, syncs


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


def scan_objective(d: int = 20):
    """The scan bench's batched Hartmann-20D over twenty unit intervals."""
    from optuna_tpu_torch.distributions import FloatDistribution
    from optuna_tpu_torch.models.benchmarks import hartmann20_torch
    from optuna_tpu_torch.parallel import VectorizedObjective

    return VectorizedObjective(hartmann20_torch, {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(d)})


def run_scan(label: str, study, objective, n_trials: int, k1_count, **kwargs) -> dict:
    """One ``optimize_scan`` call on the card with a fresh telemetry registry.
    Checks that it added ``n_trials`` COMPLETE, finite, in-box trials, prints
    the phase line (seconds per chunk and trials per second by host clock
    over the chunks and their syncs, which end in one; the phase totals; the
    device stats; K1's launches) and returns the numbers."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch import checkpoint, device_stats, telemetry
    from optuna_tpu_torch.parallel import optimize_scan

    n_before = len(study.get_trials(deepcopy=False))
    k1_before = k1_count()
    telemetry.enable(telemetry.MetricsRegistry())
    try:
        t0 = time.perf_counter()
        optimize_scan(study, objective, n_trials, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = telemetry.phase_totals()
        gauges = device_stats.stat_gauges()
    finally:
        telemetry.disable()
    k1 = k1_count() - k1_before
    new = study.get_trials(deepcopy=False)[n_before:]
    if len(new) != n_trials:
        fail(f"{label}: {len(new)} trials, expected {n_trials}")
    for t in new:
        xs = [t.params[name] for name in objective.search_space]
        if t.state != ot.TrialState.COMPLETE or not math.isfinite(t.value) or not all(0.0 <= x <= 1.0 for x in xs):
            fail(f"{label}: trial {t.number} is {t.state.name}, non-finite or out of the box")
    n_startup = sum(":cs:" in t.system_attrs[checkpoint.OP_TOKEN_ATTR] for t in new)
    chunk, sync = phases.get("scan.chunk", {}), phases.get("scan.sync", {})
    n_chunks = int(chunk.get("count", 0))
    loop_s = chunk.get("total_s", 0.0) + sync.get("total_s", 0.0)
    scan_trials = n_trials - n_startup
    info = {
        "wall_s": wall, "chunks": n_chunks, "s_per_chunk": chunk.get("total_s", 0.0) / max(n_chunks, 1),
        "trials_per_s": scan_trials / loop_s if loop_s else 0.0, "k1": k1, "gauges": gauges,
    }
    print(
        f"{label}: {n_trials} trials ({n_startup} startup) in {wall:.3f} s; {n_chunks} chunks, "
        f"{info['s_per_chunk']:.4f} s per chunk, {info['trials_per_s']:.3f} trials/s over the chunks and syncs; "
        f"phases {json.dumps(phases)}; device stats {json.dumps(gauges)}; K1 launches {k1}; "
        f"best value {study.best_value:.6f}"
    )
    return info


def profile_scan_chunk(label: str, n_history: int, chunk_len: int, **kwargs) -> None:
    """One chunk (its cold fit and its sync included) on a new seeded study
    of ``n_history`` trials, under the profiler: kernels and host reads
    (device-to-host copies, stream syncs) per step."""
    from optuna_tpu_torch.parallel import optimize_scan

    study, objective = seeded_study(n_history), scan_objective()
    _, _, kernels, dtoh, syncs = profiled(
        label, lambda: optimize_scan(study, objective, chunk_len, sync_every=chunk_len, seed=1, **kwargs)
    )
    print(
        f"profile {label}: per step {kernels / chunk_len:.1f} kernels, {dtoh / chunk_len:.1f} device-to-host "
        f"copies, {syncs / chunk_len:.1f} stream syncs (a chunk of {chunk_len}, its fit and sync included)"
    )


def phase_scan_fresh(k1_count) -> dict:
    """A new study, startup then two exact chunks (buckets 32 and 64), run
    twice with one seed: identical trial for trial."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import RandomSampler

    objective = scan_objective()
    runs, infos = [], []
    for k in range(2):
        study = ot.create_study(sampler=RandomSampler(seed=0))  # bypassed by the scan loop
        infos.append(run_scan(
            f"scan fresh, run {k + 1}", study, objective, SCAN_FRESH_TRIALS, k1_count,
            sync_every=16, n_startup_trials=16, seed=0,
        ))
        runs.append([(t.params, t.value) for t in study.get_trials(deepcopy=False)])
    if infos[0]["chunks"] != 2:
        fail(f"scan fresh: {infos[0]['chunks']} chunks, expected 2")
    if runs[0] != runs[1]:
        first = next(i for i, (a, b) in enumerate(zip(*runs)) if a != b)
        fail(f"scan fresh: the two seeded runs part at trial {first}")
    print(f"scan fresh: the two seeded runs are identical over {len(runs[0])} trials")
    return infos[1]


def phase_scan_exact(k1_count, profile: bool) -> dict:
    """960 seeded trials, then two exact chunks of 32 at bucket 1024."""
    study, objective = seeded_study(960), scan_objective()
    info = run_scan("scan exact", study, objective, 64, k1_count, sync_every=32, seed=0)
    g = info["gauges"]
    told = sum(int(g.get(f"device.scan.{k}.total", 0)) for k in ("rank1_updates", "refactorizations", "quarantined"))
    if info["chunks"] != 2 or told != 64:
        fail(f"scan exact: {info['chunks']} chunks, {told} tells in the device stats, expected 2 and 64")
    if profile:
        profile_scan_chunk("scan exact chunk", 960, 32)
    return info


def phase_scan_sparse(k1_count, profile: bool) -> dict:
    """4000 seeded trials, then two SGPR chunks of 32 at bucket 4096 with
    m_pad 256: K1 launches once per chunk boundary and once per swap-in."""
    study, objective = seeded_study(4000), scan_objective()
    kwargs = dict(n_exact_max=1024, n_inducing=256)
    info = run_scan("scan sparse", study, objective, 64, k1_count, sync_every=32, seed=0, **kwargs)
    g = info["gauges"]
    told = sum(int(g.get(f"device.scan.{k}.total", 0)) for k in ("rank1_updates", "refactorizations", "quarantined"))
    swaps = int(g.get("device.gp.inducing_swaps.total", -1))
    if info["chunks"] != 2 or told + swaps != 64 or int(g.get("device.gp.inducing_count.last", 0)) != 256:
        fail(f"scan sparse: {info['chunks']} chunks, {told} tells + {swaps} swaps, stats {g}")
    if info["k1"] != info["chunks"] + swaps:
        fail(f"scan sparse: K1 launched {info['k1']} times, expected {info['chunks']} chunks + {swaps} swaps")
    if profile:
        profile_scan_chunk("scan sparse chunk", 4000, 32, **kwargs)
    return info


def phase_scan_chunk(device) -> None:
    """One sparse chunk program at a small size (d = 5, bucket 128, m_pad 16,
    chunk 8) on the card and on the CPU, same inputs and draws: the fitted
    loss, the first proposal's LogEI, the chunk's fill, quarantines and
    first swap decision. K1 on the scan path against its plain version.

    The LogEI is held at the same points on both sides: each side's two
    first proposals (the card's and the CPU's) under each side's chunk-start
    model (its own fitted params and its own reduction, K1 on the card).
    The value the ascent itself ends at is printed too but not held: its 16
    truncated L-BFGS iterations end where the line searches stop, and a
    1-ulp change in the Gram can move that end point along the ridge."""
    import torch

    from optuna_tpu_torch.distributions import FloatDistribution
    from optuna_tpu_torch.gp.acqf import LogEIData, logei_value
    from optuna_tpu_torch.gp.gp import _loss, params_from_raw
    from optuna_tpu_torch.gp.search_space import SearchSpace
    from optuna_tpu_torch.gp.sparse import sgpr_reduce
    from optuna_tpu_torch.ops.kernels import matern
    from optuna_tpu_torch.parallel import VectorizedObjective, scan_loop
    from optuna_tpu_torch.samplers._gp.sampler import _DeviceSpace

    d, n_real, bucket, m_pad, chunk, n_pool, min_noise = 5, 100, 128, 16, 8, 128, 1e-5

    def f(p):
        x = torch.stack([p[f"x{i}"] for i in range(d)], dim=-1)
        return torch.sum((x - 0.3) ** 2, dim=-1) - 0.2 * torch.sin(6.0 * x[:, 0])

    objective = VectorizedObjective(f, {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(d)})
    space = SearchSpace(objective.search_space)
    rng = np.random.default_rng(4)
    cpu = torch.device("cpu")
    X = torch.zeros(bucket, d)
    X[:n_real] = torch.as_tensor(rng.uniform(size=(n_real, d)), dtype=torch.float32)
    mask = (torch.arange(bucket) < n_real).to(torch.float32)
    y = torch.where(mask > 0, -f({f"x{i}": X[:, i] for i in range(d)}), torch.zeros(bucket))
    default = np.r_[np.zeros(d + 1), np.log(1e-2)].astype(np.float32)
    starts = torch.as_tensor(np.stack([default] + [default + rng.normal(size=d + 2).astype(np.float32) for _ in range(3)]))
    Z, zy, zm = scan_loop._seed_inducing_program(m_pad)(X, y, mask)
    shifts, gumbels = scan_loop._chunk_draws(0, 0, chunk, d, scan_loop._N_INCUMBENTS + n_pool, cpu)
    outs = {}
    for dev in (device, cpu):
        program = scan_loop._chunk_program_sparse(
            objective, space, _DeviceSpace(space, n_pool, dev), fit_iters=48, minimum_noise=min_noise,
            maximize=False, n_local_search=4, lbfgs_iters=16,
        )
        before = matern.LAUNCHES
        out = program(*(t.to(dev) for t in (starts, X, y, mask)), n_real, *(t.to(dev) for t in (Z, zy, zm, shifts, gumbels)))
        outs[dev.type] = (out, matern.LAUNCHES - before)
    (card, launches), (host, _) = outs[device.type], outs["cpu"]
    cat = torch.zeros(d, dtype=torch.bool)
    mu, sd, _ = scan_loop._chunk_moments(y, mask)
    zy_std = torch.where(zm > 0, (zy - mu) / sd, torch.zeros_like(zy))
    loss = [float(_loss(o.raw.cpu()[None], Z, zy_std, cat, zm, min_noise)[0]) for o in (card, host)]
    loss_err = abs(loss[0] - loss[1]) / abs(loss[1])
    points = torch.stack([card.xs[0].cpu(), host.xs[0].cpu()])

    def start_logei(out, dev):
        # The chunk-start model of ``out``'s side, rebuilt as the chunk
        # program builds it, scoring both sides' first proposals.
        on = lambda t: t.to(dev)  # noqa: E731
        mu_d, sd_d, y_std = scan_loop._chunk_moments(on(y), on(mask))
        zs = torch.where(on(zm) > 0, (on(zy) - mu_d) / sd_d, torch.zeros_like(on(zy)))
        params = params_from_raw(out.raw, d, min_noise)
        state = sgpr_reduce(params, on(Z), zs, on(zm), on(X), y_std, on(mask), on(cat))[0]
        best = scan_loop._incumbent_best(y_std, on(mask))
        data = LogEIData(state=state, cat_mask=on(cat), best=best, stabilizing_noise=on(torch.tensor(1e-10)))
        return logei_value(data, on(points)).cpu()

    logei = [start_logei(o, dv) for o, dv in ((card, device), (host, cpu))]
    logei_err = float(torch.max(torch.abs(logei[0] - logei[1])))
    ascent_gap = abs(float(card.acq[0]) - float(host.acq[0]))
    same = [card.stats[k] == host.stats[k] for k in ("scan.chunk_fill", "scan.quarantined")]
    print(
        f"scan chunk card vs CPU (d={d}, bucket {bucket}, m_pad {m_pad}, chunk {chunk}): fitted loss rel err "
        f"{loss_err:.3e} (tolerance {SCAN_LOSS_RTOL}), first proposals' LogEI abs err {logei_err:.3e} (tolerance "
        f"{SCAN_LOGEI_ATOL}; card {logei[0].tolist()}, CPU {logei[1].tolist()}; the ascents ended at "
        f"{float(card.acq[0]):.6f}/{float(host.acq[0]):.6f}, gap {ascent_gap:.3e}, not held); fill "
        f"{card.stats['scan.chunk_fill']}/{host.stats['scan.chunk_fill']}, quarantined "
        f"{card.stats['scan.quarantined']}/{host.stats['scan.quarantined']}, first swap {card.swaps[:1]}/{host.swaps[:1]}; "
        f"K1 launches on the card {launches} ({card.stats['gp.inducing_swaps']} swaps)"
    )
    if not (loss_err <= SCAN_LOSS_RTOL and logei_err <= SCAN_LOGEI_ATOL and all(same) and card.swaps[:1] == host.swaps[:1]):
        fail("the scan chunk disagrees between the card and the CPU")
    if launches != 1 + card.stats["gp.inducing_swaps"]:
        fail(f"the scan chunk on the card launched K1 {launches} times, expected 1 + its swaps")


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


def phase_sobol_device(device, gpu: str) -> None:
    """``ops/qmc.py::sobol_sample_device`` on the card: plain torch, no kernel
    of the repo. Unshifted, its (2048, 20) points are SciPy's
    ``scramble=False`` stream bit for bit; with a seeded generator they are
    the same Gray-code XOR done in numpy from the shift the generator drew."""
    import torch
    from scipy.stats import qmc

    from optuna_tpu_torch.ops.qmc import sobol_sample_device

    n, d, seed = 2048, 20, 2026
    raw = sobol_sample_device(n, d, device=device)
    want = qmc.Sobol(d=d, scramble=False).random(n)
    if raw.device.type != "cuda" or raw.dtype != torch.float32 or tuple(raw.shape) != (n, d):
        fail(f"sobol_sample_device gave {raw.dtype} {tuple(raw.shape)} on {raw.device}")
    raw_diff = int(np.count_nonzero(raw.cpu().numpy().astype(np.float64) != want))

    shifted = sobol_sample_device(n, d, generator=torch.Generator(device=device).manual_seed(seed), device=device)
    shift = torch.randint(
        0, 1 << 30, (d,), generator=torch.Generator(device=device).manual_seed(seed), dtype=torch.int64, device=device
    ).cpu().numpy()
    sv = qmc.Sobol(d=d, scramble=False)._sv[:, :30].astype(np.int64)
    i = np.arange(n, dtype=np.int64)
    gray = i ^ (i >> 1)
    acc = np.zeros((n, d), np.int64)
    for b in range(30):
        acc ^= ((gray >> b) & 1)[:, None] * sv[None, :, b]
    want_shifted = (acc ^ shift[None, :]).astype(np.float32) * np.float32(2.0**-30)
    shifted_diff = int(np.count_nonzero(shifted.cpu().numpy() != want_shifted))

    raw_ms = cuda_ms(lambda: sobol_sample_device(n, d, device=device), reps=20)
    gen = torch.Generator(device=device).manual_seed(seed)
    shifted_ms = cuda_ms(lambda: sobol_sample_device(n, d, generator=gen, device=device), reps=20)
    print(
        f"Sobol device ({n}, {d}): unshifted {raw_ms:.4f} ms, {raw_diff} of {n * d} values off SciPy; shifted "
        f"{shifted_ms:.4f} ms, {shifted_diff} off the numpy XOR (tolerance 0, bit for bit); {gpu}"
    )
    if raw_diff or shifted_diff:
        fail(f"sobol_sample_device disagrees: {raw_diff} unshifted and {shifted_diff} shifted values differ")


# ------------------------------------------------------------------- TPE


def tpe_study(objective, n_trials: int, device=None, directions=None, callbacks=(), study_name=None, pruner=None,
              **kwargs):
    """A seeded TPE study (``seed=0``; ``device`` None is the card) and the
    host clock after each trial."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import TPESampler

    sampler = TPESampler(seed=0, **({} if device is None else {"device": device}), **kwargs)
    study = ot.create_study(directions=directions or ["minimize"], sampler=sampler, study_name=study_name,
                            pruner=pruner)
    stamps: list[float] = []
    study.optimize(objective, n_trials=n_trials, callbacks=[*callbacks, lambda s, t: stamps.append(time.perf_counter())])
    return study, stamps


def warm_ms(stamps: list[float], warmup: int = TPE_WARMUP) -> float:
    """ms per trial over the trials after the first ``warmup`` (bench.py's
    timed window); every ask ends in its read, so the host clock waits for
    the card."""
    return (stamps[-1] - stamps[warmup - 1]) / (len(stamps) - warmup) * 1e3


def trial_rows(study) -> list:
    return [(t.number, t.state.name, t.params, t.values) for t in study.get_trials(deepcopy=False)]


def sync_sites(fn) -> dict[str, int]:
    """Synchronizing CUDA calls made by ``fn`` (``torch.cuda.set_sync_debug_mode
    ("warn")``), by the innermost calling line in the repo's package."""
    import traceback
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    package = os.path.join(root, "optuna_tpu_torch")
    sites: dict[str, int] = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack() if f.filename.startswith(package)]
        where = frames[-1] if frames else None
        site = f"{os.path.relpath(where.filename, root)}:{where.lineno}" if where else f"{filename}:{lineno}"
        sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def ask_costs(study, objective, asks: int = 5) -> tuple[int, float, dict]:
    """Synchronizing calls a TPE ask makes (those whose stack reaches the
    package; the sites of all) and kernels it runs on the card (profiler),
    over ``asks`` more trials of ``study`` each. The syncs are counted
    first: the profiler's own teardown may sync afterwards, from no frame
    of the ask."""
    sites = sync_sites(lambda: study.optimize(objective, n_trials=asks))
    kernels = device_kernels(lambda: study.optimize(objective, n_trials=1), calls=asks)
    in_ask = sum(v for k, v in sites.items() if k.startswith("optuna_tpu_torch"))
    return kernels, in_ask / asks, {k: v / asks for k, v in sites.items()}


def check_tpe_study(label: str, study, n_trials: int) -> None:
    import optuna_tpu_torch as ot

    trials = study.get_trials(deepcopy=False)
    done = [t for t in trials if t.state == ot.TrialState.COMPLETE]
    if len(trials) != n_trials or len(done) != n_trials:
        fail(f"{label}: {len(done)} of {len(trials)} trials COMPLETE, expected {n_trials}")
    if not all(all(math.isfinite(v) for v in t.values) for t in done):
        fail(f"{label}: non-finite objective values")


def two_dim_mixed(trial) -> float:
    """One float and one four-way categorical: the types of ``highdim_mixed``
    at 2 dims, for the kernels-per-ask comparison."""
    x = trial.suggest_float("x", -3.0, 3.0)
    return x * x + {"a": 0.0, "b": 0.3, "c": 0.6, "d": 0.9}[trial.suggest_categorical("c", ["a", "b", "c", "d"])]


def phase_tpe(gpu: str) -> dict:
    """TPE on ``highdim_mixed`` (30 dims) and Branin (2 dims): twin seeded
    studies on the card, the warm window's ms per trial on the card and in
    CPU torch, kernels and synchronizing calls an ask."""
    from optuna_tpu_torch.models.benchmarks import branin, highdim_mixed

    out = {}
    for label, objective, kwargs in (
        ("univariate", highdim_mixed, {}),
        ("multivariate+group+constant liar", highdim_mixed,
         dict(multivariate=True, group=True, constant_liar=True, warn_independent_sampling=False)),
        ("branin", branin, {}),
    ):
        t0 = time.perf_counter()
        card, stamps = tpe_study(objective, TPE_TRIALS, **kwargs)
        twin, _ = tpe_study(objective, TPE_TRIALS, **kwargs)
        t_card = time.perf_counter()
        check_tpe_study(f"TPE {label}", card, TPE_TRIALS)
        if trial_rows(card) != trial_rows(twin):
            fail(f"TPE {label}: the seeded study run twice on the card differs")
        cpu, cpu_stamps = tpe_study(objective, TPE_TRIALS, device="cpu", **kwargs)
        check_tpe_study(f"TPE {label} (CPU)", cpu, TPE_TRIALS)
        t_cpu = time.perf_counter()
        kernels, syncs, sites = ask_costs(card, objective)
        row = {
            "card_ms": warm_ms(stamps), "cpu_ms": warm_ms(cpu_stamps), "kernels": kernels, "syncs": syncs,
            "best_card": card.best_value, "best_cpu": cpu.best_value, "study": card,
        }
        out[label] = row
        print(
            f"TPE {label} ({objective.__name__}, {TPE_TRIALS} trials, seed 0; {gpu}): twin identical trial for "
            f"trial; ms per trial over trials {TPE_WARMUP}-{TPE_TRIALS - 1}: card {row['card_ms']:.3f}, CPU torch "
            f"{row['cpu_ms']:.3f}; {kernels} kernels an ask, {syncs:.2f} synchronizing calls an ask "
            f"({json.dumps(sites)}); best value card {card.best_value:.6f}, CPU {cpu.best_value:.6f}; phase "
            f"seconds: card and twin {t_card - t0:.1f}, CPU {t_cpu - t_card:.1f}, costs {time.perf_counter() - t_cpu:.1f}"
        )
    mixed, _ = tpe_study(two_dim_mixed, 40)
    k2, _, _ = ask_costs(mixed, two_dim_mixed)
    k30 = out["univariate"]["kernels"]
    print(
        f"TPE kernels an ask: {k30} at 30 dims (25 numerical, 5 categorical), {k2} at 2 dims (1 numerical, "
        f"1 categorical), {out['branin']['kernels']} at Branin's 2 numerical dims (no categorical batch)"
    )
    if abs(k30 - k2) > 2:
        fail(f"TPE: an ask runs {k30} kernels at 30 dims against {k2} at 2 dims of the same types")
    if out["branin"]["kernels"] > k30:
        fail("TPE: Branin's ask runs more kernels than highdim_mixed's")
    for label, row in out.items():
        if row["syncs"] > 1:
            fail(f"TPE {label}: {row['syncs']} synchronizing calls an ask, expected the one read")
    out["kernels_2d_mixed"] = k2
    return out


class _Prefix:
    """The first ``n`` trials of a study, as the sampler's split reads them."""

    def __init__(self, study, n: int) -> None:
        self._study = study
        self._trials = study.get_trials(deepcopy=False)[:n]

    def _get_trials(self, deepcopy=False, states=None, use_cache=False):
        return [t for t in self._trials if states is None or t.state in states]

    def __getattr__(self, name):
        return getattr(self._study, name)


def phase_tpe_asks(label: str, study, joint: bool) -> None:
    """``TPE_ASKS`` asks packed from ``study``'s own history (its last
    ``TPE_ASKS`` prefixes), each run on the card and on the CPU with the same
    packed inputs and the same draws: the same chosen candidate, scores
    within ``TPE_SCORE_TOL``; where the choice differs the two best scores
    must be within the tolerance (a near tie), and those asks are counted."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import TPESampler
    from optuna_tpu_torch.samplers._tpe import _kernels

    card_sampler = study.sampler
    cpu_sampler = TPESampler(seed=0, device="cpu", multivariate=joint)
    p = card_sampler._parzen_estimator_parameters
    trials = study.get_trials(deepcopy=False)
    space = dict(trials[-1].distributions)
    devices = {"card": card_sampler.device, "cpu": torch.device("cpu")}
    specs = {"card": card_sampler._univariate_space_spec(space), "cpu": cpu_sampler._univariate_space_spec(space)}
    widths = torch.as_tensor(specs["cpu"]["highs"] - specs["cpu"]["lows"], dtype=torch.float64)
    rng = np.random.RandomState(0)
    states = (ot.TrialState.COMPLETE, ot.TrialState.PRUNED)
    near_ties = score_gap = cand_gap = 0.0
    fn = _kernels.sample_and_score_from_obs if joint else _kernels.sample_univariate_from_obs
    real_score = _kernels._score
    for n in range(len(trials) - TPE_ASKS, len(trials)):
        prefix = _Prefix(study, n)
        below_t, above_t = card_sampler._split(prefix, space, states, False)
        spec = specs["cpu"]
        sets = [card_sampler._pack_observations(prefix, spec, below_t, True),
                card_sampler._pack_observations(prefix, spec, above_t, False)]
        seed = int(rng.randint(0, 2**31 - 1))
        shape = (seed, len(spec["num_items"]), len(spec["cat_items"]), card_sampler._n_ei_candidates,
                 len(sets[0][2]), spec["cat_cmax"], torch.device("cpu"))
        draws = _kernels.joint_draws(*shape) if joint else _kernels.univariate_draws(*shape)
        outs = {}
        for side, dev in devices.items():
            spec = specs[side]
            below, above = _kernels.upload_obs(
                sets, spec["lows"], spec["highs"], spec["n_choices"], p.prior_weight, p.consider_magic_clip,
                spec["space"].dist_mats is not None, dev,
            )
            moved = (
                _kernels.Draws(*(t.to(dev) for t in draws)) if joint
                else tuple(_kernels.Draws(*(t.to(dev) for t in d)) for d in draws)
            )
            captured = []
            _kernels._score = lambda b, a, d: captured.append(real_score(b, a, d)) or captured[-1]  # noqa: E731
            try:
                fn(below, above, spec["space"], moved, p.consider_endpoints)
            finally:
                _kernels._score = real_score
            outs[side] = [tuple(t.cpu() for t in c) for c in captured]
        for (xn_c, xc_c, sc_c), (xn_g, xc_g, sc_g) in zip(outs["cpu"], outs["card"]):
            if not torch.equal(torch.isfinite(sc_c), torch.isfinite(sc_g)) or not torch.equal(xc_c, xc_g):
                fail(f"TPE asks {label}: card and CPU differ in a categorical sample or a non-finite score")
            fin = torch.isfinite(sc_c)
            rel = (sc_c[fin].double() - sc_g[fin].double()).abs() / sc_c[fin].double().abs().clamp(min=1.0)
            score_gap = max(score_gap, float(rel.max()) if rel.numel() else 0.0)
            if xn_c.shape[2]:
                w = widths[None, None, :] if joint else widths[:, None, None]
                cand_gap = max(cand_gap, float(((xn_c.double() - xn_g.double()).abs() / w).max()))
            best_c, best_g = sc_c.argmax(dim=1), sc_g.argmax(dim=1)
            for q in torch.nonzero(best_c != best_g).flatten().tolist():
                gap = max(float(sc_c[q, best_c[q]] - sc_c[q, best_g[q]]), float(sc_g[q, best_g[q]] - sc_g[q, best_c[q]]))
                if gap > TPE_SCORE_TOL * max(1.0, abs(float(sc_c[q, best_c[q]]))):
                    fail(f"TPE asks {label}: the card and the CPU choose apart at history {n} by {gap:.3e}")
                near_ties += 1
    if score_gap > TPE_SCORE_TOL or cand_gap > TPE_CAND_TOL:
        fail(f"TPE asks {label}: card against CPU, scores {score_gap:.3e} apart, candidates {cand_gap:.3e}")
    print(
        f"TPE asks {label}: {TPE_ASKS} asks from the study's history (prefixes {len(trials) - TPE_ASKS}-"
        f"{len(trials) - 1}), card against CPU with the same inputs and draws: every choice equal but "
        f"{int(near_ties)} near tie(s) (best scores within {TPE_SCORE_TOL:.0e}); max score gap {score_gap:.3e} "
        f"(relative), max candidate gap {cand_gap:.3e} of a width (tolerances {TPE_SCORE_TOL:.0e}, "
        f"{TPE_CAND_TOL:.0e})"
    )


def host_ranks(values: np.ndarray) -> np.ndarray:
    """Full non-domination ranks by the host's NumPy peeling."""
    ranks = np.full(len(values), -1, dtype=np.int64)
    remaining, rank = np.arange(len(values)), 0
    while len(remaining):
        vals = values[remaining]
        dom = np.all(vals[:, None] <= vals[None], axis=2) & np.any(vals[:, None] < vals[None], axis=2)
        dominated = dom.any(axis=0)
        ranks[remaining[~dominated]] = rank
        remaining, rank = remaining[dominated], rank + 1
    return ranks


def phase_motpe(nds, gpu: str) -> dict:
    """MOTPE (``TPESampler(seed=0)`` on a two-objective study) on ZDT1, 30
    variables, 576 trials: from 512 complete trials every ask's split ranks
    through K2 on the card, and none before; the first such ranking equals
    the host's; the seeded study run twice is identical."""
    import optuna_tpu_torch.study._multi_objective as mo
    from optuna_tpu_torch.models.benchmarks import zdt1

    first: dict = {}
    real = mo._fast_non_domination_rank

    def spy(values, **kwargs):
        ranks = real(values, **kwargs)
        if not first and len(values) >= mo._DEVICE_RANK_MIN_POINTS:
            first.update(values=np.array(values), ranks=ranks.copy())
        return ranks

    after: list[int] = []
    mo._fast_non_domination_rank = spy
    try:
        study, stamps = tpe_study(
            lambda t: zdt1(t, dim=ZDT_DIM), MOTPE_TRIALS, directions=["minimize", "minimize"],
            callbacks=[lambda s, t: after.append(nds.RANK_LAUNCHES)],
        )
    finally:
        mo._fast_non_domination_rank = real
    launches = nds.RANK_LAUNCHES
    check_tpe_study("MOTPE", study, MOTPE_TRIALS)
    per_ask = np.diff([0, *after])  # trial t's ask saw t complete trials
    early, late = per_ask[: mo._DEVICE_RANK_MIN_POINTS], per_ask[mo._DEVICE_RANK_MIN_POINTS:]
    if early.any() or not (late >= 1).all():
        fail(f"MOTPE: K2 launched before 512 complete trials ({int(early.sum())}) or missed an ask from there "
             f"({int((late < 1).sum())} asks without a launch)")
    if not first or not np.array_equal(first["ranks"], host_ranks(first["values"])):
        fail("MOTPE: K2's ranks at the first ask from 512 trials differ from the host's")
    twin, _ = tpe_study(lambda t: zdt1(t, dim=ZDT_DIM), MOTPE_TRIALS, directions=["minimize", "minimize"])
    if trial_rows(study) != trial_rows(twin):
        fail("MOTPE: the seeded study run twice on the card differs")
    kernels, syncs, sites = ask_costs(study, lambda t: zdt1(t, dim=ZDT_DIM), asks=3)
    ms = warm_ms(stamps, warmup=mo._DEVICE_RANK_MIN_POINTS)
    early_ms = (stamps[mo._DEVICE_RANK_MIN_POINTS - 1] - stamps[TPE_WARMUP - 1]) / (
        mo._DEVICE_RANK_MIN_POINTS - TPE_WARMUP) * 1e3
    print(
        f"MOTPE ZDT1 (d={ZDT_DIM}, {MOTPE_TRIALS} trials, seed 0; {gpu}): twin identical; K2 ranked on every one "
        f"of the {len(late)} asks from 512 complete trials ({int(late.sum())} launches) and on none before; the "
        f"first ranking ({len(first['values'])} points, {int(first['ranks'].max()) + 1} fronts) equals the host's; "
        f"ms per trial: {early_ms:.3f} over trials {TPE_WARMUP}-{mo._DEVICE_RANK_MIN_POINTS - 1} (host split), "
        f"{ms:.3f} over trials {mo._DEVICE_RANK_MIN_POINTS}-{MOTPE_TRIALS - 1} (K2 split); an ask past {MOTPE_TRIALS} "
        f"trials: {kernels} kernels, {syncs:.2f} synchronizing calls ({json.dumps(sites)})"
    )
    return {"launches": launches, "ms": ms, "early_ms": early_ms}


def phase_hyperband(gpu: str) -> None:
    """A TPE study on the card under HyperbandPruner: every trial's bracket
    is the crc32 rule's, and every trial list the sampler reads through
    ``_filter_study`` holds only the asking trial's bracket."""
    import zlib

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.pruners import HyperbandPruner, _hyperband

    seen: list = []
    real = _hyperband._BracketStudy._get_trials

    def spy(self, *args, **kwargs):
        trials = real(self, *args, **kwargs)
        seen.append(all(self._pruner._get_bracket_id(self._study, t) == self._bracket_id for t in trials))
        return trials

    def stepped(trial) -> float:
        x = trial.suggest_float("x", 0.0, 1.0)
        k = trial.suggest_int("k", 0, 3)
        for step in range(9):
            trial.report(x + 0.1 * step + 0.01 * k, step)
            if trial.should_prune():
                raise ot.TrialPruned()
        return x + 0.8 + 0.01 * k

    _hyperband._BracketStudy._get_trials = spy
    try:
        pruner = HyperbandPruner(min_resource=1, max_resource=9, reduction_factor=3)
        study, _ = tpe_study(stepped, 120, study_name="hyperband-tpe", pruner=pruner)
    finally:
        _hyperband._BracketStudy._get_trials = real

    def crc32_bracket(number: int) -> int:
        n = zlib.crc32(f"hyperband-tpe_{number}".encode()) % pruner._total_trial_allocation_budget
        for bracket_id, budget in enumerate(pruner._trial_allocation_budgets):
            n -= budget
            if n < 0:
                return bracket_id
        raise AssertionError

    trials = study.get_trials(deepcopy=False)
    brackets = [pruner._get_bracket_id(study, t) for t in trials]
    if brackets != [crc32_bracket(t.number) for t in trials]:
        fail("Hyperband: a trial's bracket differs from the crc32 rule")
    if not seen or not all(seen):
        fail(f"Hyperband: the sampler read trials of another bracket ({seen.count(False)} of {len(seen)} reads)")
    pruned = sum(t.state == ot.TrialState.PRUNED for t in trials)
    print(
        f"Hyperband + TPE on the card ({gpu}): 120 trials, {pruner._n_brackets} brackets "
        f"({[brackets.count(b) for b in range(pruner._n_brackets)]} trials), {pruned} pruned; every bracket "
        f"equals the crc32 rule; {len(seen)} trial reads through the bracket view, all inside the asking "
        f"trial's bracket"
    )


def phase_default() -> None:
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import branin
    from optuna_tpu_torch.samplers import TPESampler

    study = ot.create_study()
    study.optimize(branin, n_trials=12)
    if not isinstance(study.sampler, TPESampler) or study.sampler.device.type != "cuda":
        fail(f"create_study() gives {type(study.sampler).__name__} on {getattr(study.sampler, 'device', None)}")
    print(f"default: create_study() with one objective samples with TPESampler on {study.sampler.device}")



# ------------------------------------------------------- the runtime (18-19)

RUNTIME_JOBS = 4  # n_jobs of the threaded TPE and NSGA-II studies
NSGA_THREADED_TRIALS = 768  # generations 0-2 at population 256: generation 2's selection ranks 512 (K2)
# The threaded retry study: at least RETRY_TRIALS COMPLETE trials, at most
# RETRY_BUDGET trials; trial RETRY_AT's objective raises once.
RETRY_TRIALS, RETRY_BUDGET, RETRY_AT = 40, 200, 12
GRID_POINTS = {"a": [0, 1, 2], "b": [-1.0, 0.0, 1.0], "c": ["p", "q", "r", "s"]}  # 3 x 3 x 4
GUARDED_TRIALS, GUARDED_NAN_AT, GUARDED_RAISE_AT = 60, 30, 5
# Trial 0 has no relative search space and asks no relative suggestion, so
# FaultySampler's suggestion #k is trial k + 1.


class ThreadLog:
    """Wraps an objective to record the names of the threads that ran it and
    each call's host-clock seconds (the ask happens inside, at the first
    suggest)."""

    def __init__(self) -> None:
        import threading

        self.names: set[str] = set()
        self.seconds: list[float] = []
        self._lock = threading.Lock()

    def wrap(self, objective):
        import threading

        def run(trial):
            with self._lock:
                self.names.add(threading.current_thread().name)
            t0 = time.perf_counter()
            try:
                return objective(trial)
            finally:
                with self._lock:
                    self.seconds.append(time.perf_counter() - t0)

        return run

    def spread_ms(self) -> str:
        ms = np.asarray(self.seconds) * 1e3
        return f"median {np.median(ms):.1f} ms, p99 {np.percentile(ms, 99):.1f} ms, max {ms.max():.1f} ms"

    def workers_only(self) -> bool:
        import threading

        return bool(self.names) and threading.main_thread().name not in self.names


def in_distributions(trial) -> bool:
    return all(d._contains(d.to_internal_repr(trial.params[k])) for k, d in trial.distributions.items())


def retry_on_fail():
    """``RetryFailedTrialCallback`` as an optimize callback: it clones only
    FAIL trials (it is written as a storage's failed-trial callback)."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.storages import RetryFailedTrialCallback

    retry = RetryFailedTrialCallback(max_retry=1)
    return lambda study, trial: retry(study, trial) if trial.state == ot.TrialState.FAIL else None


def check_threaded(label: str, study, n_trials: int, log: ThreadLog | None, distinct: bool = True) -> list:
    """Every trial COMPLETE and inside its distributions, numbers dense, with
    ``distinct`` no two trials alike (NSGA-II copies a parent now and then by
    design), and, for a threaded run, every objective on a worker thread.
    Distinct points do not show that the workers reseeded: they share one
    sampler and draw one after another from its stream either way
    (``tests/test_torch_runtime.py`` spies on the reseed)."""
    import optuna_tpu_torch as ot

    trials = study.get_trials(deepcopy=False)
    if sorted(t.number for t in trials) != list(range(n_trials)):
        fail(f"{label}: trial numbers are not 0-{n_trials - 1}")
    if not all(t.state == ot.TrialState.COMPLETE for t in trials):
        fail(f"{label}: {sum(t.state != ot.TrialState.COMPLETE for t in trials)} trials not COMPLETE")
    if not all(in_distributions(t) and all(math.isfinite(v) for v in t.values) for t in trials):
        fail(f"{label}: a trial is outside its distributions or non-finite")
    if distinct and len({tuple(sorted(t.params.items())) for t in trials}) != n_trials:
        fail(f"{label}: two trials have the same params")
    if log is not None and (not log.workers_only() or len(log.names) < 2):
        fail(f"{label}: the objectives ran on {sorted(log.names)}, expected worker threads only")
    return trials


def phase_threads_tpe(gpu: str) -> dict:
    """TPE on ``highdim_mixed`` at ``n_jobs`` 1 and 4 on the card, with
    ``MaxTrialsCallback`` and the retry callback attached; then a threaded
    study whose objective raises once: exactly one retry clone."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import highdim_mixed
    from optuna_tpu_torch.samplers import TPESampler
    from optuna_tpu_torch.study import MaxTrialsCallback

    out = {}
    for jobs in (1, RUNTIME_JOBS):
        log = ThreadLog()
        stamps: list[float] = []
        study = ot.create_study(sampler=TPESampler(seed=0))
        objective = log.wrap(highdim_mixed)
        t0 = time.perf_counter()
        study.optimize(
            objective, n_trials=TPE_TRIALS, n_jobs=jobs,
            callbacks=[MaxTrialsCallback(TPE_TRIALS), retry_on_fail(), lambda s, t: stamps.append(time.perf_counter())],
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_threaded(f"TPE n_jobs={jobs}", study, TPE_TRIALS, log if jobs > 1 else None)
        if study.sampler.device.type != "cuda":
            fail(f"TPE n_jobs={jobs} sampled on {study.sampler.device}")
        out[jobs] = {"ms": seconds / TPE_TRIALS * 1e3, "warm_ms": warm_ms(sorted(stamps)), "threads": len(log.names),
                     "spread": log.spread_ms()}

    log = ThreadLog()
    t0 = time.perf_counter()
    events: dict[str, float] = {}

    def flaky(trial):
        value = highdim_mixed(trial)
        if trial.number == RETRY_AT:
            events["raised"] = time.perf_counter() - t0
            raise RuntimeError("injected objective failure")
        return value

    def cloned(study, trial):
        if trial.state == ot.TrialState.FAIL:
            events["cloned_at_trials"] = len(study.get_trials(deepcopy=False))

    def stop_once_retried(study, trial):
        """Stop at RETRY_TRIALS COMPLETE trials once the clone has been
        claimed: a worker can lag (on an H100 one told its FAIL after 43
        other trials), and a clone enqueued after the last claim would
        stay WAITING."""
        trials = study.get_trials(deepcopy=False)
        if (sum(t.state == ot.TrialState.COMPLETE for t in trials) >= RETRY_TRIALS
                and any("failed_trial" in t.system_attrs for t in trials)
                and not any(t.state == ot.TrialState.WAITING for t in trials)):
            study.stop()

    study = ot.create_study(sampler=TPESampler(seed=0))
    study.optimize(log.wrap(flaky), n_trials=RETRY_BUDGET, n_jobs=RUNTIME_JOBS, catch=(RuntimeError,),
                   callbacks=[retry_on_fail(), cloned, stop_once_retried])
    trials = study.get_trials(deepcopy=False)
    failed = [t for t in trials if t.state == ot.TrialState.FAIL]
    clones = [t for t in trials if "failed_trial" in t.system_attrs]
    if [t.number for t in failed] != [RETRY_AT] or len(clones) != 1:
        fail(f"TPE retry: FAIL trials {[t.number for t in failed]}, {len(clones)} clones; expected trial "
             f"{RETRY_AT} and one clone")
    clone = clones[0]
    attrs = clone.system_attrs
    if (attrs["failed_trial"], attrs["retry_history"], attrs["fixed_params"]) != (
            RETRY_AT, [RETRY_AT], failed[0].params) or clone.params != failed[0].params:
        fail(f"TPE retry: the clone's attrs {attrs} do not name trial {RETRY_AT} and its params")
    complete = sum(t.state == ot.TrialState.COMPLETE for t in trials)
    if clone.state != ot.TrialState.COMPLETE or complete < RETRY_TRIALS or not log.workers_only():
        fail(f"TPE retry: clone {clone.state.name}, {complete} of {len(trials)} trials COMPLETE, threads "
             f"{sorted(log.names)}, {events}")
    print(
        f"threads TPE highdim_mixed ({TPE_TRIALS} trials, seed 0, MaxTrialsCallback + retry callback; {gpu}): "
        f"ms per trial n_jobs=1 {out[1]['ms']:.3f} (trials {TPE_WARMUP}-{TPE_TRIALS - 1}: {out[1]['warm_ms']:.3f}; "
        f"a trial's objective call {out[1]['spread']}), n_jobs={RUNTIME_JOBS} {out[RUNTIME_JOBS]['ms']:.3f} "
        f"({out[RUNTIME_JOBS]['warm_ms']:.3f}; {out[RUNTIME_JOBS]['spread']}) on "
        f"{out[RUNTIME_JOBS]['threads']} worker threads; all COMPLETE, numbers dense, no two trials alike; retry "
        f"study (stopped once cloned at {complete} COMPLETE of {len(trials)} trials, n_jobs="
        f"{RUNTIME_JOBS}): trial {RETRY_AT} FAIL (raised at {events['raised']:.3f} s, cloned when "
        f"{events['cloned_at_trials']} trials existed), its one clone is trial {clone.number} (failed_trial "
        f"{attrs['failed_trial']}, retry_history {attrs['retry_history']}), COMPLETE"
    )
    return out


def phase_threads_gp(k1_count) -> dict:
    """Sparse GP asks on the card from two worker threads, from one
    4000-trial history. One untimed ask first takes the cold fit and builds
    the device space; then warm asks run 2 sequential, 4 at ``n_jobs=2``,
    2 sequential, so that neither way runs only early or only late."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import hartmann20

    study = seeded_study(4000)
    n_history = len(study.get_trials(deepcopy=False))
    study.optimize(hartmann20, n_trials=1)
    torch.cuda.synchronize()

    def timed(n_trials: int, jobs: int, objective=hartmann20) -> float:
        t0 = time.perf_counter()
        study.optimize(objective, n_trials=n_trials, n_jobs=jobs)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    seq_before = timed(2, 1)
    log = ThreadLog()
    before = k1_count()
    thr_s = timed(4, 2, log.wrap(hartmann20))
    k1 = k1_count() - before
    seq_after = timed(2, 1)
    seq_ask = (seq_before + seq_after) / 4
    thr_ask = thr_s / 4
    trials = study.get_trials(deepcopy=False)
    new = trials[n_history:]
    if len(new) != 9 or not all(t.state == ot.TrialState.COMPLETE for t in new):
        fail(f"threads GP: {len(new)} new trials, states {[t.state.name for t in new]}")
    for t in new:
        if not (math.isfinite(t.value) and all(0.0 <= t.params[f"x{i}"] <= 1.0 for i in range(20))):
            fail(f"threads GP: trial {t.number} is non-finite or out of the box")
    if not log.workers_only() or len(log.names) != 2:
        fail(f"threads GP: the objectives ran on {sorted(log.names)}, expected two worker threads")
    if k1 < 4:
        fail(f"threads GP: K1 launched {k1} times over the 4 threaded sparse asks, expected >= 4")
    print(
        f"threads GP sparse (n={n_history}, Hartmann-20D, one untimed warm-up ask, then warm asks): sequential "
        f"{seq_before:.3f} s for two before and {seq_after:.3f} s for two after the threaded ones, "
        f"{seq_ask:.3f} s an ask; four asks at n_jobs=2 {thr_s:.3f} s, {thr_ask:.3f} s an ask "
        f"(concurrent/sequential {thr_ask / seq_ask:.3f}); K1 {k1} launches from the worker threads "
        f"{sorted(log.names)}; all COMPLETE, finite, in the box"
    )
    return {"seq_ask_s": seq_ask, "thr_ask_s": thr_ask, "k1": k1}


def phase_threads_nsga(nds, nsga_s: float) -> dict:
    """NSGA-II on ZDT1 at population 256 from four worker threads: the
    selection of generation 2 ranks 512 trials through K2."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import zdt1
    from optuna_tpu_torch.samplers import NSGAIISampler

    log = ThreadLog()
    before = nds.RANK_LAUNCHES
    study = ot.create_study(directions=["minimize", "minimize"],
                            sampler=NSGAIISampler(seed=0, population_size=NSGA_POP))
    t0 = time.perf_counter()
    study.optimize(log.wrap(lambda t: zdt1(t, dim=ZDT_DIM)), n_trials=NSGA_THREADED_TRIALS, n_jobs=RUNTIME_JOBS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ranks = nds.RANK_LAUNCHES - before
    check_threaded("threads NSGA-II", study, NSGA_THREADED_TRIALS, log, distinct=False)
    if ranks < 1:
        fail("threads NSGA-II: the ranking kernels never launched from the worker threads")
    generations = sorted({t.system_attrs.get("NSGAIISampler:generation") for t in study.get_trials(deepcopy=False)})
    print(
        f"threads NSGA-II ZDT1 (population {NSGA_POP}, {NSGA_THREADED_TRIALS} trials, n_jobs={RUNTIME_JOBS}): "
        f"{seconds / NSGA_THREADED_TRIALS * 1e3:.3f} ms per trial ({seconds:.2f} s; phase 6 at n_jobs=1: "
        f"{nsga_s / NSGA_TRIALS * 1e3:.3f}); K2 ranked {ranks} times from the worker threads "
        f"{sorted(log.names)}; generations {generations}; all COMPLETE"
    )
    return {"ms": seconds / NSGA_THREADED_TRIALS * 1e3, "ranks": ranks}


def fallback_trials(study) -> list[int]:
    from optuna_tpu_torch.samplers._resilience import SAMPLER_FALLBACK_ATTR_PREFIX

    return [t.number for t in study.get_trials(deepcopy=False)
            if any(k.startswith(SAMPLER_FALLBACK_ATTR_PREFIX) for k in t.system_attrs)]


def phase_wrappers(gpu: str) -> None:
    """PartialFixed over GP on the card, Grid and BruteForce to exhaustion,
    GuardedSampler over TPE on the card (free when fault-free; a NaN
    proposal degrades its one trial; a kernel build failure propagates)."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import branin, hartmann20
    from optuna_tpu_torch.ops.kernels._nvcc import KernelBuildError
    from optuna_tpu_torch.samplers import (
        BruteForceSampler, GPSampler, GridSampler, GuardedSampler, PartialFixedSampler, TPESampler,
    )
    from optuna_tpu_torch.testing.fault_injection import FaultySampler

    study = seeded_study(1000)
    n_history = len(study.get_trials(deepcopy=False))
    study.sampler = PartialFixedSampler({"x0": 0.5}, GPSampler(seed=0))
    t0 = time.perf_counter()
    study.optimize(hartmann20, n_trials=2)
    pf_s = time.perf_counter() - t0
    new = study.get_trials(deepcopy=False)[n_history:]
    if len(new) != 2 or study.sampler._base_sampler._device.type != "cuda":
        fail(f"PartialFixed over GP samples on {study.sampler._base_sampler._device}")
    for t in new:
        if t.state != ot.TrialState.COMPLETE or t.params["x0"] != 0.5 or not math.isfinite(t.value):
            fail(f"PartialFixed over GP: trial {t.number} {t.state.name}, x0 {t.params['x0']}")
        if not all(0.0 <= t.params[f"x{i}"] <= 1.0 for i in range(1, 20)):
            fail(f"PartialFixed over GP: trial {t.number} is out of the box")

    def grid_objective(trial):
        a = trial.suggest_int("a", 0, 2)
        b = trial.suggest_float("b", -1.0, 1.0)
        return a + b + "pqrs".index(trial.suggest_categorical("c", GRID_POINTS["c"]))

    grid = ot.create_study(sampler=GridSampler(GRID_POINTS, seed=0))
    grid.optimize(grid_objective, n_trials=100)
    points = [(t.params["a"], t.params["b"], t.params["c"]) for t in grid.get_trials(deepcopy=False)]
    want = {(a, b, c) for a in GRID_POINTS["a"] for b in GRID_POINTS["b"] for c in GRID_POINTS["c"]}
    if len(points) != 36 or set(points) != want:
        fail(f"Grid: {len(points)} trials over {len(set(points))} points, expected each of 36 once")

    def brute_objective(trial):
        k = trial.suggest_int("k", 0, 3)
        return k + {"x": 0.0, "y": 0.5, "z": 1.0}[trial.suggest_categorical("c", ["x", "y", "z"])]

    brute = ot.create_study(sampler=BruteForceSampler(seed=0))
    brute.optimize(brute_objective, n_trials=100)
    leaves = [(t.params["k"], t.params["c"]) for t in brute.get_trials(deepcopy=False)]
    if len(leaves) != 12 or set(leaves) != {(k, c) for k in range(4) for c in "xyz"}:
        fail(f"BruteForce: {len(leaves)} trials over {len(set(leaves))} leaves, expected each of 12 once")

    plain, _ = tpe_study(branin, GUARDED_TRIALS)
    guarded = ot.create_study(sampler=GuardedSampler(TPESampler(seed=0)))
    guarded.optimize(branin, n_trials=GUARDED_TRIALS)
    if trial_rows(guarded) != trial_rows(plain) or fallback_trials(guarded):
        fail("GuardedSampler: the fault-free guarded study differs from the unwrapped one")
    nan = ot.create_study(sampler=GuardedSampler(FaultySampler(TPESampler(seed=0), nan_at={GUARDED_NAN_AT - 1})))
    nan.optimize(branin, n_trials=GUARDED_TRIALS)
    rows = nan.get_trials(deepcopy=False)
    if fallback_trials(nan) != [GUARDED_NAN_AT] or trial_rows(nan)[:GUARDED_NAN_AT] != trial_rows(plain)[:GUARDED_NAN_AT]:
        fail(f"GuardedSampler: fallbacks at {fallback_trials(nan)}, expected exactly trial {GUARDED_NAN_AT}")
    reason = rows[GUARDED_NAN_AT].system_attrs.get("sampler_fallback:relative", "")
    if "non-finite" not in reason or not all(
            t.state == ot.TrialState.COMPLETE and in_distributions(t) and math.isfinite(t.value) for t in rows):
        fail(f"GuardedSampler: the degraded trial's attr {reason!r}, or a trial not COMPLETE/finite/in range")

    def build_error(index):
        return KernelBuildError(f"nvcc failed (injected at suggest #{index})")

    broken = ot.create_study(sampler=GuardedSampler(FaultySampler(TPESampler(seed=0), raise_at={GUARDED_RAISE_AT - 1},
                                                                  error_factory=build_error)))
    try:
        broken.optimize(branin, n_trials=10)
    except KernelBuildError:
        pass
    else:
        fail("GuardedSampler: a KernelBuildError from the wrapped sampler did not propagate")
    states = [t.state.name for t in broken.get_trials(deepcopy=False)]
    if states != ["COMPLETE"] * GUARDED_RAISE_AT + ["FAIL"] or fallback_trials(broken):
        fail(f"GuardedSampler: after the KernelBuildError states {states}, fallbacks {fallback_trials(broken)}")
    print(
        f"wrappers ({gpu}): PartialFixed({{'x0': 0.5}}) over GPSampler on {study.sampler._base_sampler._device}, "
        f"2 asks at n={n_history} in {pf_s:.2f} s, "
        f"x0 exactly 0.5, x1-x19 in the box; Grid 3x3x4 stopped at {len(points)} trials, each point once; "
        f"BruteForce enumerated its {len(leaves)} leaves; GuardedSampler(TPE) {GUARDED_TRIALS} Branin trials "
        f"identical to the unwrapped run; a NaN proposal degraded exactly trial {GUARDED_NAN_AT} "
        f"({reason[:60]!r}); a KernelBuildError at trial {GUARDED_RAISE_AT} propagated, no fallback"
    )


# ------------------------------- the rest of multi-objective, CMA-ES (20-24)

HSSP_N, HSSP_M, HSSP_K = 512, 5, 16  # bench.py::run_hv_selection at full width
SLICE_TOL_F64 = 1e-4  # f32 slicing against the f64 oracle (tests/test_hypervolume.py: rtol 1e-4)
SLICE_TOL_CPU = 1e-5  # the same torch ops on the card and the CPU, sums in another order
HSSP_TIE = 1e-5  # two greedy picks part only if their f64 gains differ by at most this share of the selection's HV
HSSP_HV_TOL = 1e-3  # hypervolume of the selected set on the card (f32 stack) against f64
MOTPE3_HSSP, MOTPE3_MAX_TRIALS, DTLZ2_DIM = 5, 1500, 12  # device HSSP asks to reach, the cap, DTLZ2's variables
CMA_DIM, CMA_POP, CMA_TRIALS, CMA_WARMUP = 50, 40, 2000, 500  # config #3 (bench.py --config cmaes), cut from 5000
CMA_VARIANT_TRIALS = 200


def sphere_front(n: int, m: int, seed: int) -> np.ndarray:
    """``n`` points on the positive unit sphere, mapped to ``1 - 0.9 u``: all
    non-dominated, inside the reference point ``ones(m)``."""
    rng = np.random.RandomState(seed)
    raw = np.abs(rng.normal(size=(n, m))) + 1e-3
    return 1.0 - 0.9 * raw / np.linalg.norm(raw, axis=1, keepdims=True)


def timed(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_slicing() -> None:
    """The slicing engine on the card through the routed functions: M = 3 at
    1500 sphere points and M = 4 at 256, and the leave-one-out at M = 3 over
    128 points, against the host f64 oracle and ``device="cpu"``."""
    from optuna_tpu_torch.hypervolume import compute_hypervolume, loo_contributions
    from optuna_tpu_torch.hypervolume.wfg import compute_hypervolume as host_hv

    for m, n in ((3, 1500), (4, 256)):
        front, ref = sphere_front(n, m, seed=m), np.ones(m)
        compute_hypervolume(front, ref)  # first call: allocator and library set-up
        card, card_s = timed(lambda: compute_hypervolume(front, ref))
        cpu, cpu_s = timed(lambda: compute_hypervolume(front, ref, device="cpu"))
        oracle, oracle_s = timed(lambda: host_hv(front, ref, assume_pareto=True))
        e64, ecpu = abs(card - oracle) / oracle, abs(card - cpu) / cpu
        print(
            f"slicing M={m}, {n} sphere points (all non-dominated; route threshold "
            f"{'1024' if m == 3 else '64'}): card {card:.9f} in {card_s:.4f} s, CPU {cpu:.9f} in {cpu_s:.3f} s, host "
            f"f64 {oracle:.9f} in {oracle_s:.3f} s; rel err vs f64 {e64:.3e} (tolerance {SLICE_TOL_F64}), vs CPU "
            f"{ecpu:.3e} (tolerance {SLICE_TOL_CPU})"
        )
        if not (math.isfinite(card) and e64 <= SLICE_TOL_F64 and ecpu <= SLICE_TOL_CPU):
            fail(f"slicing M={m}: the card disagrees with the f64 oracle or the CPU")
    front, ref = sphere_front(128, 3, seed=5), np.ones(3)
    loo_contributions(front, ref)
    card, card_s = timed(lambda: loo_contributions(front, ref))
    cpu, cpu_s = timed(lambda: loo_contributions(front, ref, device="cpu"))
    want, oracle_s = timed(lambda: host_loo(front, ref))
    total = host_hv(front, ref, assume_pareto=True)
    err, err_cpu = float(np.max(np.abs(card - want))) / total, float(np.max(np.abs(card - cpu))) / total
    print(
        f"slicing leave-one-out M=3, 128 points: card {card_s:.4f} s, CPU {cpu_s:.3f} s, host oracle {oracle_s:.3f} "
        f"s; max |card - oracle| / total {err:.3e} (tolerance {LOO_TOL}), |card - CPU| / total {err_cpu:.3e} "
        f"(tolerance {SLICE_TOL_CPU}); {int(np.sum(card > 0))} positive"
    )
    if not (np.isfinite(card).all() and err <= LOO_TOL and err_cpu <= SLICE_TOL_CPU):
        fail("slicing leave-one-out disagrees with the host oracle or the CPU")


def parting_gap(got: np.ndarray, want: np.ndarray, pts: np.ndarray, ref: np.ndarray):
    """``None`` when two greedy selections are equal; else ``(step, gap)``
    at their first parting, the gap of the two picks' f64 gains over the
    f64 hypervolume of the selection up to that step."""
    from optuna_tpu_torch.hypervolume.wfg import _compute_hv_recursive

    for step, (g, w) in enumerate(zip(got, want)):
        if g != w:
            base = _compute_hv_recursive(pts[list(want[:step])], ref) if step else 0.0
            gains = [_compute_hv_recursive(pts[list(want[:step]) + [i]], ref) - base for i in (g, w)]
            return step, abs(gains[0] - gains[1]) / _compute_hv_recursive(pts[list(want[: step + 1])], ref)
    return None


def hssp_stack_check(device) -> None:
    """K3 at the HSSP's shapes: the first greedy step's (512, 17, 5) candidate
    roots through the stack kernel and the plain stack loop on the card,
    the same bits and node counts. Before the path's counters are reset."""
    import torch

    from optuna_tpu_torch.ops import hypervolume as ops_hv
    from optuna_tpu_torch.ops import wfg as ops_wfg
    from optuna_tpu_torch.ops.kernels import wfg as kernels

    front = np.random.RandomState(0).uniform(0.0, 1.0, size=(HSSP_N, HSSP_M))
    pts, _ = ops_hv._padded(front, np.ones(HSSP_M), device)
    ref = torch.ones(HSSP_M, device=device)
    k_pad = HSSP_K
    cand = torch.cat([ref.expand(len(pts), k_pad, HSSP_M), pts[:, None, :]], dim=1)
    roots = ops_wfg._roots(cand, ref, torch.ones(cand.shape[:2], dtype=torch.bool, device=device))
    acc, nodes = kernels.wfg_stack(*roots, ref)
    plain_acc, plain_nodes = kernels.wfg_stack_plain(*roots, ref)
    torch.cuda.synchronize()
    same = torch.equal(acc, plain_acc) and torch.equal(nodes, plain_nodes)
    print(f"wfg_stack at the HSSP's first step {tuple(roots[0].shape)}: bit-exact {same}, "
          f"{int(nodes.sum())} nodes in all")
    if not same:
        fail("wfg_stack at the HSSP's shapes differs from the plain stack loop")


def phase_hssp(stack, twins: CpuTwins) -> dict:
    """The device HSSP at ``bench.py::run_hv_selection``'s shapes: 512
    ``RandomState(0)`` uniform points, M = 5, ``ones(5)``, k = 16, through K3
    (one launch a greedy step), against ``device="cpu"`` (the plain stack
    loop) and the host lazy greedy (``hypervolume/hssp.py``); then M = 3 at
    256 points through the slicing scorer, with no launch."""
    from optuna_tpu_torch.hypervolume.hssp import solve_hssp as host_hssp
    from optuna_tpu_torch.hypervolume.wfg import _compute_hv_recursive
    from optuna_tpu_torch.ops.hypervolume import solve_hssp_device
    from optuna_tpu_torch.ops.wfg import hypervolume_wfg_nd

    out = {}
    for m, n in ((HSSP_M, HSSP_N), (3, 256)):
        front, ref = np.random.RandomState(0).uniform(0.0, 1.0, size=(n, m)), np.ones(m)
        before = stack.STACK_LAUNCHES
        card, card_s = timed(lambda: solve_hssp_device(front, ref, HSSP_K))
        launches = stack.STACK_LAUNCHES - before
        if m == HSSP_M:
            cpu, cpu_s = twins.get("hssp")
        else:
            cpu, cpu_s = timed(lambda: solve_hssp_device(front, ref, HSSP_K, device="cpu"))
        host, host_s = timed(lambda: host_hssp(front, ref, HSSP_K))
        gaps = {label: parting_gap(card, other, front, ref) for label, other in (("CPU", cpu), ("host", host))}
        # The picks' f32 hypervolume by the plain stack (a check: no launch on the path's count).
        hv_card = hypervolume_wfg_nd(front[card], ref, device="cpu") if m >= 5 else None
        hv64 = _compute_hv_recursive(front[card], ref)
        hv_err = abs(hv_card - hv64) / hv64 if hv_card is not None else 0.0
        print(
            f"HSSP M={m}, {n} uniform points, k={HSSP_K}: card {card_s:.4f} s ({launches} stack launches), CPU "
            f"{cpu_s:.3f} s, host lazy greedy {host_s:.3f} s; card picks {card.tolist()}; parting from the CPU "
            f"{gaps['CPU']}, from the host {gaps['host']} ((step, f64 gain gap / HV), tolerance {HSSP_TIE}); HV of the "
            f"picks {hv64:.9f} (f64)" + (f", f32 stack {hv_card:.9f}, rel err {hv_err:.3e} (tolerance "
                                         f"{HSSP_HV_TOL})" if hv_card is not None else "")
        )
        for label, gap in gaps.items():
            if gap is not None and gap[1] > HSSP_TIE:
                fail(f"HSSP M={m}: the card's selection parts from the {label}'s at step {gap[0]}, not at a near tie")
        if hv_err > HSSP_HV_TOL or len(set(card.tolist())) != HSSP_K:
            fail(f"HSSP M={m}: the selected set's hypervolume is off, or picks repeat")
        expected = HSSP_K if m >= 5 else 0
        if launches != expected:
            fail(f"HSSP M={m}: wfg_stack launched {launches} times, expected {expected}")
        out[m] = {"card_s": card_s, "cpu_s": cpu_s, "host_s": host_s, "launches": launches}
    return out


def run_nsga3(device_arg) -> tuple:
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import zdt1
    from optuna_tpu_torch.samplers import NSGAIIISampler

    kwargs = {} if device_arg is None else {"device": device_arg}
    study = ot.create_study(
        directions=["minimize", "minimize"], sampler=NSGAIIISampler(seed=0, population_size=NSGA_POP, **kwargs)
    )
    t0 = time.perf_counter()
    study.optimize(lambda t: zdt1(t, dim=ZDT_DIM), n_trials=NSGA_TRIALS)
    torch.cuda.synchronize()
    return study, time.perf_counter() - t0


def phase_nsga3(nds) -> dict:
    """NSGA-III on config #4's ZDT1 at population 256, 1024 trials, on the
    card and the CPU: identical trial for trial; generations 2 and 3 rank
    512 trials through K2."""
    before = nds.RANK_LAUNCHES
    card, card_s = run_nsga3(None)
    ranks = nds.RANK_LAUNCHES - before
    cpu, cpu_s = run_nsga3("cpu")
    if nsga_summary(card) != nsga_summary(cpu):
        fail("NSGA-III: the study on the card differs from the same study on the CPU")
    values = np.asarray([t.values for t in card.get_trials(deepcopy=False)])
    if len(values) != NSGA_TRIALS or not np.isfinite(values).all():
        fail("NSGA-III: missing or non-finite objective values")
    if ranks < 2:
        fail(f"NSGA-III: nds_rank launched {ranks} times over generations 2 and 3")
    print(
        f"NSGA-III ZDT1 (d={ZDT_DIM}, population {NSGA_POP}, {NSGA_TRIALS} trials): identical to the CPU run trial "
        f"for trial; K2 ranked {ranks} times; card {card_s / NSGA_TRIALS * 1e3:.3f} ms/trial ({card_s:.2f} s), CPU "
        f"{cpu_s / NSGA_TRIALS * 1e3:.3f} ms/trial ({cpu_s:.2f} s)"
    )
    return {"ranks": ranks, "ms": card_s / NSGA_TRIALS * 1e3}


def dtlz2(trial, dim: int = DTLZ2_DIM, m: int = 3):
    """DTLZ2 (Deb, Thiele, Laumanns and Zitzler 2002) on ``m`` objectives:
    the front is the positive unit sphere at ``g = 0``."""
    xs = [trial.suggest_float(f"x{i}", 0.0, 1.0) for i in range(dim)]
    g = sum((x - 0.5) ** 2 for x in xs[m - 1:])
    out = []
    for i in range(m):
        f = 1.0 + g
        for x in xs[: m - 1 - i]:
            f *= math.cos(x * math.pi / 2)
        if i > 0:
            f *= math.sin(xs[m - 1 - i] * math.pi / 2)
        out.append(f)
    return tuple(out)


def phase_motpe3(stack, gpu: str) -> dict:
    """MOTPE (``TPESampler(seed=0)``) on three-objective DTLZ2 with 12
    variables, on the card, until the split's HSSP has taken the device
    route ``MOTPE3_HSSP`` times (the first rank reaches 128 points)."""
    from optuna_tpu_torch.ops import hypervolume as ops_hv

    calls: list[int] = []
    real = ops_hv.solve_hssp_device

    def spy(points, *args, **kwargs):
        calls.append(len(points))
        return real(points, *args, **kwargs)

    def stop(study, trial):
        if len(calls) >= MOTPE3_HSSP:
            study.stop()

    before = stack.STACK_LAUNCHES
    ops_hv.solve_hssp_device = spy
    try:
        study, stamps = tpe_study(dtlz2, MOTPE3_MAX_TRIALS, directions=["minimize"] * 3, callbacks=[stop])
    finally:
        ops_hv.solve_hssp_device = real
    n = len(study.get_trials(deepcopy=False))
    check_tpe_study("MOTPE DTLZ2", study, n)
    if len(calls) < MOTPE3_HSSP:
        fail(f"MOTPE DTLZ2: the device HSSP ran {len(calls)} times in {n} trials")
    if stack.STACK_LAUNCHES != before:
        fail("MOTPE DTLZ2: the three-objective HSSP launched the WFG stack: it scores by slicing")
    first = n - len(calls)
    ms = (stamps[-1] - stamps[first - 1]) / len(calls) * 1e3
    early = (stamps[first - 1] - stamps[TPE_WARMUP - 1]) / (first - TPE_WARMUP) * 1e3
    print(
        f"MOTPE DTLZ2 (3 objectives, {DTLZ2_DIM} variables, seed 0; {gpu}): the device HSSP ran from trial {first} "
        f"({n} trials in all; rank sizes {calls}); ms per trial {early:.3f} over trials {TPE_WARMUP}-{first - 1} "
        f"(host HSSP), {ms:.3f} over the {len(calls)} asks through the device HSSP"
    )
    return {"trials": n, "first": first, "ms": ms}


def cma_study(n_trials: int, device=None, objective=None, **kwargs):
    """A seeded CMA-ES study (``device`` None is the card) and the host clock
    after each trial."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import rastrigin
    from optuna_tpu_torch.samplers import CmaEsSampler

    sampler = CmaEsSampler(warn_independent_sampling=False, **({} if device is None else {"device": device}), **kwargs)
    study = ot.create_study(sampler=sampler)
    stamps: list[float] = []
    study.optimize(objective or (lambda t: rastrigin(t, dim=CMA_DIM)), n_trials=n_trials,
                   callbacks=[lambda s, t: stamps.append(time.perf_counter())])
    torch.cuda.synchronize()
    return study, sampler, stamps


def cma_generation_costs(study) -> tuple[int, dict]:
    """Kernels (profiler) and synchronizing calls (by repo line) of one
    generation of config #3's study on the card: ``CMA_POP`` more trials,
    one fused tell and ask and its one read among them."""
    from optuna_tpu_torch.models.benchmarks import rastrigin

    def generation():
        study.optimize(lambda t: rastrigin(t, dim=CMA_DIM), n_trials=CMA_POP)

    sites = sync_sites(generation)
    return device_kernels(generation, calls=2), sites


def phase_cmaes(gpu: str) -> dict:
    """BASELINE.md config #3: ``CmaEsSampler(seed=0, popsize=40)`` on 50-D
    Rastrigin, 2000 trials (50 generations; the config's 5000 cut for time),
    twice on the card (identical) and once with ``device="cpu"``; then each
    device branch for 200 trials on the card."""
    card, sampler, stamps = cma_study(CMA_TRIALS, seed=0, popsize=CMA_POP)
    twin, _, _ = cma_study(CMA_TRIALS, seed=0, popsize=CMA_POP)
    cpu, _, cpu_stamps = cma_study(CMA_TRIALS, device="cpu", seed=0, popsize=CMA_POP)
    check_tpe_study("CMA-ES", card, CMA_TRIALS)
    if trial_rows(card) != trial_rows(twin):
        fail("CMA-ES: the seeded study run twice on the card differs")
    state, extra = sampler._restore_state(card)
    gens = int(extra["generation"])
    if state.mean.device.type != "cuda" or gens != CMA_TRIALS // CMA_POP - 1:
        fail(f"CMA-ES: the state is on {state.mean.device} at generation {gens}")
    ms, cpu_ms = warm_ms(stamps, CMA_WARMUP), warm_ms(cpu_stamps, CMA_WARMUP)
    best = card.best_value  # before the generations the costs add
    kernels, sites = cma_generation_costs(card)
    syncs = sum(v for k, v in sites.items() if k.startswith("optuna_tpu_torch"))
    print(
        f"CMA-ES config #3 (Rastrigin d={CMA_DIM}, popsize {CMA_POP}, {CMA_TRIALS} trials, seed 0; {gpu}): twin "
        f"identical; generation {gens} stored on the card; ms per trial over trials {CMA_WARMUP}-{CMA_TRIALS - 1}: "
        f"card {ms:.3f}, CPU torch {cpu_ms:.3f}; best value card {best:.4f} (twin {twin.best_value:.4f}), "
        f"CPU {cpu.best_value:.4f}; a generation's tell+ask+read: {kernels} kernels, {syncs} synchronizing calls "
        f"({json.dumps(sites)})"
    )

    def mixed(trial):
        k = trial.suggest_int("k", 0, 10)
        j = trial.suggest_int("j", 0, 20, step=2)
        xs = [trial.suggest_float(f"x{i}", -2.0, 2.0) for i in range(6)]
        return float((k - 3) ** 2 + (j - 14) ** 2 + sum(x * x for x in xs))

    def plateau(trial):
        return 7.0 + 0.0 * sum(trial.suggest_float(f"x{i}", -5.12, 5.12) for i in range(10))

    variants = {
        "use_separable_cma": dict(use_separable_cma=True),
        "lr_adapt": dict(lr_adapt=True),
        "with_margin (int/float)": dict(with_margin=True, objective=mixed),
        # A plateau trips tolfun after 10 flat generations: restarts on the card.
        "restart_strategy=ipop, popsize 4 (plateau)": dict(restart_strategy="ipop", popsize=4, objective=plateau),
    }
    parts = []
    for label, kwargs in variants.items():
        kw = dict(kwargs)
        objective = kw.pop("objective", None)
        if objective is None:
            from optuna_tpu_torch.models.benchmarks import rastrigin

            objective = lambda t: rastrigin(t, dim=10)  # noqa: E731
        study, vsampler, vstamps = cma_study(CMA_VARIANT_TRIALS, objective=objective, seed=0, **kw)
        check_tpe_study(f"CMA-ES {label}", study, CMA_VARIANT_TRIALS)
        vstate, vextra = vsampler._restore_state(study)
        if vstate.mean.device.type != "cuda":
            fail(f"CMA-ES {label}: the state left the card")
        if "ipop" in label and not (int(vextra["n_restarts"]) >= 1 and int(vextra["popsize"]) >= 8):
            fail(f"CMA-ES {label}: no IPOP restart on a plateau")
        parts.append(
            f"{label}: best {study.best_value:.4f}, generation {int(vextra['generation'])}, restarts "
            f"{int(vextra['n_restarts'])} (popsize {int(vextra['popsize'])}), "
            f"{(vstamps[-1] - vstamps[0]) / (len(vstamps) - 1) * 1e3:.3f} ms/trial"
        )
    print(f"CMA-ES variants on the card ({CMA_VARIANT_TRIALS} trials each; Rastrigin d=10 unless said): "
          + "; ".join(parts))
    return {"ms": ms, "cpu_ms": cpu_ms, "kernels": kernels, "syncs": syncs, "best": best}


# ------------------------------------------------ the rest of the GP sampler (25-28)

CHAIN_Q = 8  # bench.py's config #2: GPSampler(seed=0, speculative_chain=8)
CHAIN_EXACT_FROM, CHAIN_EXACT_TRIALS = 960, 32  # 4 dispatches at n = 960 ... 984, all at bucket 1024
CHAIN_SPARSE_FROM, CHAIN_SPARSE_TRIALS = 4000, 16  # 2 sparse dispatches, K1 once each
RUNNING_TRIALS = {2: 4, 4: 6}  # n_jobs -> trials from 1000 seeded ones: 2 qLogEI asks a setting at least (8 and
#                                 12, then 6 and 8, cut as the script's total neared its limit)
RUNNING_SEQ_ASKS = 1  # asks beside one RUNNING trial from 1000 and from 4000 (2 before the same cut)
GP_CARD_CPU_TOL = 1e-3  # the first host-route ask on the card against the CPU, normalized space
GP_TIE = 1e-3  # ... a parting is allowed only where the two winners' acquisition values are this close
ZDT_GP_FROM, DTLZ_GP_FROM = 300, 200
MO_PARITY_FROM = 64  # LogEHVI card against CPU: one ask each from this many seeded trials


def sum_constraint(trial) -> tuple[float]:
    """Phase 27's constraint on Hartmann-20D: feasible where the twenty
    coordinates sum to at most 10 (about half the cube)."""
    return (sum(trial.params[f"x{i}"] for i in range(20)) - 10.0,)


class _Spy:
    """Wraps ``owner.name`` from the script (the package holds no counter of
    its own): counts the calls and keeps what ``record`` makes of each
    call's arguments and result."""

    def __init__(self, owner, name: str, record=None) -> None:
        import threading

        self.owner, self.name, self.real = owner, name, getattr(owner, name)
        self.calls: list = []
        lock = threading.Lock()

        def spy(*args, **kwargs):
            out = self.real(*args, **kwargs)
            with lock:
                self.calls.append(record(args, kwargs, out) if record else None)
            return out

        setattr(owner, name, spy)

    def close(self) -> None:
        setattr(self.owner, self.name, self.real)


def hartmann_space() -> dict:
    from optuna_tpu_torch.distributions import FloatDistribution

    return {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(20)}


def check_gp_trials(label: str, study, first: int, n_new: int) -> None:
    import optuna_tpu_torch as ot

    new = study.get_trials(deepcopy=False)[first:]
    if len(new) != n_new or not all(t.state == ot.TrialState.COMPLETE for t in new):
        fail(f"{label}: {len(new)} new trials, states {sorted({t.state.name for t in new})}, expected {n_new} COMPLETE")
    for t in new:
        if not (all(math.isfinite(v) for v in t.values) and all(0.0 <= x <= 1.0 for x in t.params.values())):
            fail(f"{label}: trial {t.number} is non-finite or out of the box")


def distinct_and_seen(study, rows) -> tuple[int, int]:
    """How many of ``rows`` (params dicts) are distinct, and how many of
    those repeat a finished trial's params exactly."""
    seen = {tuple(t.params[f"x{i}"] for i in range(20)) for t in study.get_trials(deepcopy=False) if t.params}
    keys = {tuple(p[f"x{i}"] for i in range(20)) for p in rows}
    return len(keys), len(keys & seen)


def check_batch(label: str, study, proposals: list) -> tuple[int, int]:
    """A batch of ``CHAIN_Q`` finite points in the box that the fantasies
    pushed apart (the reference's own test: not all one point). The chain
    can return an observed point: where the pool's best LogEI is far below
    an incumbent's, a round's best start is that incumbent, where the LogEI
    gradient is in the hundreds; the maximizer's shortest trial step (2^-9
    of it) overshoots the narrow rise around the observed point, no step is
    accepted, and the round returns the incumbent. The reference's program
    does the same on this history's second dispatch
    (``tests/torch_chain_witness.py``). The distinct and repeated counts
    are printed."""
    pts = np.array([[p[f"x{i}"] for i in range(20)] for p in proposals])
    if pts.shape != (CHAIN_Q, 20) or not np.all(np.isfinite(pts) & (pts >= 0.0) & (pts <= 1.0)):
        fail(f"{label}: sample_relative_batch gave {pts.shape}, expected {CHAIN_Q} points in the box")
    distinct, repeated = distinct_and_seen(study, proposals)
    if distinct < 2:
        fail(f"{label}: the batch of {CHAIN_Q} is one point: the fantasies did not push the proposals apart")
    return distinct, repeated


def phase_chain(k1_count, exact_ask_s: list[float], sparse_ask_s: list[float]) -> dict:
    """Config #2 as bench.py runs it: ``GPSampler(seed=0,
    speculative_chain=8)`` on Hartmann-20D. 32 trials from 960 seeded ones
    (4 exact chain dispatches at 960, 968, 976, 984 trials, bucket 1024), 16
    from 4000 (2 sparse dispatches, K1 once each), a batch of 8 at each
    size, beside the per-trial asks of phases 4 (n = 1000, the same bucket)
    and 5 (n = 4000)."""
    import torch

    from optuna_tpu_torch.gp import fused
    from optuna_tpu_torch.models.benchmarks import hartmann20

    out = {}
    spy = _Spy(fused, "gp_suggest_chain_fused", lambda a, kw, o: (a[1].shape[0], a[5]))
    exact_dispatches = None
    try:
        for label, n0, n_trials in (
            ("exact", CHAIN_EXACT_FROM, CHAIN_EXACT_TRIALS), ("sparse", CHAIN_SPARSE_FROM, CHAIN_SPARSE_TRIALS),
        ):
            study = seeded_study(n0, speculative_chain=CHAIN_Q)
            n0 = len(study.get_trials(deepcopy=False))
            # Each dispatch's trial count and the distinct design rows among them.
            dispatches = _Spy(type(study.sampler), "_sample_chain",
                              lambda a, kw, o: (len(a[4]), len(np.unique(a[3], axis=0))))
            try:
                before = k1_count()
                t0 = time.perf_counter()
                study.optimize(hartmann20, n_trials=n_trials)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                k1 = k1_count() - before
                check_gp_trials(f"chain {label}", study, n0, n_trials)
                trials = study.get_trials(deepcopy=False)
                chain_distinct = len({tuple(t.params.values()) for t in trials[n0:]})
                if len(dispatches.calls) != n_trials // CHAIN_Q:
                    fail(f"chain {label}: {len(dispatches.calls)} chain dispatches for {n_trials} trials")
                before = k1_count()
                t1 = time.perf_counter()
                batch = study.sampler.sample_relative_batch(study, hartmann_space(), CHAIN_Q)
                torch.cuda.synchronize()
                batch_s = time.perf_counter() - t1
                k1_batch = k1_count() - before
            finally:
                dispatches.close()
            if label == "exact":
                exact_dispatches = dispatches.calls
            distinct, repeated = check_batch(f"chain {label}", study, batch)
            out[label] = {"ms": seconds / n_trials * 1e3, "k1": k1, "k1_batch": k1_batch, "batch_s": batch_s,
                          "best": study.best_value, "trials_distinct": chain_distinct, "batch": (distinct, repeated)}
    finally:
        spy.close()
    from optuna_tpu_torch.gp.gp import _bucket

    # One dispatch every CHAIN_Q trials, then the batch. A dispatch's n is
    # the count of distinct design rows among its trials: a trial that
    # repeats another's params (see check_batch) collapses into that row.
    ns = list(range(CHAIN_EXACT_FROM, CHAIN_EXACT_FROM + CHAIN_EXACT_TRIALS + 1, CHAIN_Q))  # the last: the batch
    if (
        len(spy.calls) != len(ns) or [t for t, _ in exact_dispatches] != ns
        or [r for _, r in spy.calls] != [r for _, r in exact_dispatches]
        or any(b != _bucket(r + CHAIN_Q) or b != _bucket(ns[-1] + CHAIN_Q) for b, r in spy.calls)
    ):
        fail(f"chain exact: dispatches (bucket, n) {spy.calls} at (trials, distinct rows) {exact_dispatches}, "
             f"expected n the distinct rows, at {ns} trials, in one bucket {_bucket(ns[-1] + CHAIN_Q)} holding "
             f"n + {CHAIN_Q}")
    expected = spy.calls[:-1]
    if out["exact"]["k1"] or out["exact"]["k1_batch"]:
        fail(f"chain exact: K1 launched {out['exact']['k1']} / {out['exact']['k1_batch']} times below n_exact_max")
    if out["sparse"]["k1"] != CHAIN_SPARSE_TRIALS // CHAIN_Q or out["sparse"]["k1_batch"] != 1:
        fail(f"chain sparse: K1 launched {out['sparse']['k1']} times over {CHAIN_SPARSE_TRIALS // CHAIN_Q} dispatches "
             f"and {out['sparse']['k1_batch']} for the batch, expected once each")
    print(
        f"config #2 chain (GPSampler(seed=0, speculative_chain={CHAIN_Q}), Hartmann-20D): exact from "
        f"{CHAIN_EXACT_FROM}, {CHAIN_EXACT_TRIALS} trials in {len(expected)} dispatches at (bucket, distinct rows) "
        f"{expected}: "
        f"{out['exact']['ms']:.1f} ms per trial, against {exact_ask_s[0] * 1e3:.1f} (cold) and "
        f"{float(np.median(exact_ask_s[1:])) * 1e3:.1f} (warm median) ms per-trial asks (phase 4, n=1000); sparse from "
        f"{CHAIN_SPARSE_FROM}, {CHAIN_SPARSE_TRIALS} "
        f"trials: {out['sparse']['ms']:.1f} ms per trial (K1 {out['sparse']['k1']}), against "
        f"{float(np.median(sparse_ask_s)) * 1e3:.1f} ms per-trial asks (phase 5's median at n=4000); distinct "
        f"params among the chain's trials {out['exact']['trials_distinct']} / {out['sparse']['trials_distinct']}; batch "
        f"of {CHAIN_Q}: {out['exact']['batch_s']:.3f} s exact, {out['sparse']['batch_s']:.3f} s sparse (K1 "
        f"{out['sparse']['k1_batch']}), distinct points (of them equal to a trial's params) {out['exact']['batch']} / "
        f"{out['sparse']['batch']}; best {out['exact']['best']:.6f} / {out['sparse']['best']:.6f}"
    )
    return out


def _ask_in_flight():
    """An in-flight count of the GP sampler's relative asks (a script-side
    wrap) and an objective that runs Hartmann-20D, sleeps 0.2 s and then
    holds until no ask is in flight: an objective slower than an ask, so
    every ask after the workers' first finds another worker's trial RUNNING
    with its params set."""
    import threading

    from optuna_tpu_torch.models.benchmarks import hartmann20
    from optuna_tpu_torch.samplers import GPSampler

    state = {"n": 0}
    lock = threading.Lock()
    real = GPSampler.sample_relative

    def sample_relative(self, *args, **kwargs):
        with lock:
            state["n"] += 1
        try:
            return real(self, *args, **kwargs)
        finally:
            with lock:
                state["n"] -= 1

    def objective(trial):
        value = hartmann20(trial)
        time.sleep(0.2)
        deadline = time.perf_counter() + 60.0
        while state["n"] and time.perf_counter() < deadline:
            time.sleep(0.005)
        return value

    GPSampler.sample_relative = sample_relative
    return objective, lambda: setattr(GPSampler, "sample_relative", real)


def add_running_trial(study) -> int:
    """A RUNNING trial with its params set, as another worker leaves one;
    returns its number."""
    import optuna_tpu_torch as ot

    params = {f"x{i}": 0.5 for i in range(20)}
    study.add_trial(ot.create_trial(state=ot.TrialState.RUNNING, params=params, distributions=hartmann_space()))
    return study.get_trials(deepcopy=False)[-1].number


def phase_running(k1_count) -> dict:
    """qLogEI from n_jobs worker threads on the card: 1000 seeded trials,
    then trials at n_jobs 2 and 4; then ``RUNNING_SEQ_ASKS`` sequential asks
    beside a RUNNING trial from 1000 (the exact host fit) and from 4000 (the
    sparse host fit, K1 once an ask)."""
    import threading

    import torch

    from optuna_tpu_torch.models.benchmarks import hartmann20
    from optuna_tpu_torch.samplers import GPSampler

    out = {}
    objective, restore = _ask_in_flight()
    # Each ask's own time, and whether it went through qLogEI (the spy on
    # _build_qlogei marks the asking thread).
    local, lock, asks = threading.local(), threading.Lock(), []
    real_impl = GPSampler._sample_relative_impl

    def timed_impl(self, *args, **kwargs):
        local.qlogei = False
        t = time.perf_counter()
        try:
            return real_impl(self, *args, **kwargs)
        finally:
            with lock:
                asks.append((time.perf_counter() - t, local.qlogei))

    GPSampler._sample_relative_impl = timed_impl
    try:
        for jobs, n_trials in RUNNING_TRIALS.items():
            study = seeded_study(1000)
            n0 = len(study.get_trials(deepcopy=False))
            qlogei = _Spy(GPSampler, "_build_qlogei", lambda a, kw, o: setattr(local, "qlogei", True))
            asks.clear()
            before = k1_count()
            t0 = time.perf_counter()
            try:
                study.optimize(objective, n_trials=n_trials, n_jobs=jobs)
                torch.cuda.synchronize()
            finally:
                qlogei.close()
            seconds = time.perf_counter() - t0
            check_gp_trials(f"running n_jobs={jobs}", study, n0, n_trials)
            if len(qlogei.calls) < n_trials - jobs:
                fail(f"running n_jobs={jobs}: {len(qlogei.calls)} of {n_trials} asks took qLogEI, expected at least "
                     f"{n_trials - jobs}")
            if k1_count() != before:
                fail(f"running n_jobs={jobs}: K1 launched below n_exact_max")
            q_s = [s for s, took in asks if took]
            other_s = [s for s, took in asks if not took]
            out[jobs] = {"s": seconds, "qlogei": len(qlogei.calls), "trials": n_trials,
                         "qlogei_ask_s": float(np.median(q_s)), "other_ask_s": other_s}
    finally:
        GPSampler._sample_relative_impl = real_impl
        restore()
    for label, n_seeded, k1_each in (("exact", 1000, 0), ("sparse", 4000, 1)):
        study = seeded_study(n_seeded)
        n0 = len(study.get_trials(deepcopy=False))
        running = add_running_trial(study)
        qlogei = _Spy(GPSampler, "_build_qlogei")
        before = k1_count()
        t0 = time.perf_counter()
        try:
            study.optimize(hartmann20, n_trials=RUNNING_SEQ_ASKS)
            torch.cuda.synchronize()
        finally:
            qlogei.close()
        ask_s = (time.perf_counter() - t0) / RUNNING_SEQ_ASKS
        k1 = k1_count() - before
        study.tell(running, 1.0)
        check_gp_trials(f"running {label}", study, n0, RUNNING_SEQ_ASKS + 1)
        if len(qlogei.calls) != RUNNING_SEQ_ASKS or k1 != RUNNING_SEQ_ASKS * k1_each:
            fail(f"running {label}: {len(qlogei.calls)} qLogEI asks and {k1} K1 launches, expected "
                 f"{RUNNING_SEQ_ASKS} and {RUNNING_SEQ_ASKS * k1_each}")
        out[label] = {"s": ask_s, "k1": k1}
    print(
        "running trials (qLogEI, Hartmann-20D, from 1000; objective 0.2 s then held while an ask is in flight): "
        + "; ".join(f"n_jobs={j} {out[j]['trials']} trials in {out[j]['s']:.2f} s, {out[j]['qlogei']} asks through "
                    f"qLogEI at {out[j]['qlogei_ask_s']:.3f} s an ask (median), the others (the workers' first, "
                    f"the fused route) {', '.join(f'{s:.3f}' for s in out[j]['other_ask_s'])} s"
                    for j in RUNNING_TRIALS)
        + f"; {RUNNING_SEQ_ASKS} sequential ask(s) beside one RUNNING trial: {out['exact']['s']:.3f} s an ask from "
        f"1000, {out['sparse']['s']:.3f} s from 4000 (K1 {out['sparse']['k1']}); all COMPLETE"
    )
    return out


def phase_constraints(k1_count) -> dict:
    """Hartmann-20D with ``sum(x) - 10 <= 0`` through ``constraints_func``:
    1 ask from 1000 seeded trials that carry constraint attrs, 1 from
    4000 (K1 twice an ask: the objective's and the constraint's sparse
    fits)."""
    import torch

    from optuna_tpu_torch.models.benchmarks import hartmann20
    from optuna_tpu_torch.samplers import GPSampler

    out = {}
    for n_seeded, asks, k1_each in ((1000, 1, 0), (4000, 1, 2)):  # 2 each before the total neared its limit
        study = seeded_study(n_seeded, constraint=True, constraints_func=sum_constraint)
        n0 = len(study.get_trials(deepcopy=False))
        wraps = _Spy(GPSampler, "_wrap_constraints", lambda a, kw, o: o[0])
        before = k1_count()
        seconds = []
        try:
            for _ in range(asks):
                t0 = time.perf_counter()
                study.optimize(hartmann20, n_trials=1)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
        finally:
            wraps.close()
        k1 = k1_count() - before
        check_gp_trials(f"constraints n={n0}", study, n0, asks)
        new = study.get_trials(deepcopy=False)[n0:]
        if wraps.calls != ["constrained_logei"] * asks or any("constraints" not in t.system_attrs for t in new):
            fail(f"constraints n={n0}: acquisitions {wraps.calls}, expected constrained_logei on every ask")
        if k1 != k1_each * asks:
            fail(f"constraints n={n0}: K1 launched {k1} times over {asks} asks, expected {k1_each * asks}")
        feasible = sum(t.system_attrs["constraints"][0] <= 0 for t in new)
        out[n_seeded] = {"s": seconds, "k1": k1, "feasible": feasible}
    print(
        "constraints (Hartmann-20D, sum(x) - 10 <= 0): "
        + "; ".join(f"n={n}: seconds per ask {[round(x, 3) for x in o['s']]}, K1 {o['k1']}, "
                    f"{o['feasible']} of {len(o['s'])} proposals feasible" for n, o in out.items())
    )
    return out


class _Fixed:
    """A trial stand-in that answers ``suggest_float`` from fixed params, to
    seed a history through the objective's own code."""

    def __init__(self, params: dict) -> None:
        self.params = params

    def suggest_float(self, name, low, high):
        return self.params[name]


def seeded_mo_study(objective, dim: int, n_obj: int, n_history: int, device=None):
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.distributions import FloatDistribution
    from optuna_tpu_torch.samplers import GPSampler

    rng = np.random.default_rng(0)
    dists = {f"x{i}": FloatDistribution(0.0, 1.0) for i in range(dim)}
    study = ot.create_study(sampler=GPSampler(seed=0, device=device), directions=["minimize"] * n_obj)
    rows = [{f"x{i}": float(v) for i, v in enumerate(row)} for row in rng.uniform(0.0, 1.0, size=(n_history, dim))]
    study.add_trials(
        ot.create_trial(params=p, distributions=dists, values=list(objective(_Fixed(p)))) for p in rows
    )
    return study


def kernels_and_syncs(fn) -> tuple[int, dict]:
    """Kernels ``fn`` puts on the card (the device's records of a CUDA-only
    trace, counted from the raw results without building the operator
    tables, which for an ask of ~10^5 kernels takes minutes) and its
    synchronizing calls by line (:func:`sync_sites`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA)
    return kernels, sync_sites(fn)


def first_proposal(objective, dim: int, n_obj: int, n0: int, device: str) -> tuple:
    """(acquisition, box count, (x_best, value), seconds) of one LogEHVI ask
    from ``n0`` seeded trials on ``device``."""
    import torch

    from optuna_tpu_torch.gp import optim_mixed

    study = seeded_mo_study(objective, dim, n_obj, n0, device=device)
    # The sampler imports the maximizer from its module at each ask.
    om = _Spy(optim_mixed, "optimize_acqf_mixed", lambda a, kw, o: (a[0], a[1].box_lowers.shape[0], o))
    t0 = time.perf_counter()
    try:
        study.optimize(objective, n_trials=1)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        om.close()
    return (*om.calls[0], time.perf_counter() - t0)


def mo_routes() -> tuple:
    """Phase 28's routes: (label, objective, variables, objectives, seeded
    trials, asks)."""
    from optuna_tpu_torch.models.benchmarks import zdt1

    return (
        ("ZDT1", lambda t: zdt1(t, dim=ZDT_DIM), ZDT_DIM, 2, ZDT_GP_FROM, 2),  # 5 asks before phase 34, then 3
        ("DTLZ2", lambda t: dtlz2(t), DTLZ2_DIM, 3, DTLZ_GP_FROM, 2),  # 3 before the script's total neared its limit
    )


def phase_mo_gp(k1_count, twins: CpuTwins) -> dict:
    """LogEHVI on the card: ZDT1 (30 variables, 2 objectives) 2 asks from
    300 seeded trials, DTLZ2 (12 variables, 3 objectives) 2 asks from 200;
    the box count, s an ask, the kernels of one more ask and the
    synchronizing calls of another; then one ask on the card and one on the CPU (in the helper process)
    from the same ``MO_PARITY_FROM`` seeded trials (a CPU ask from 300 ZDT1 trials takes
    ~100 s on the card's host)."""
    import torch

    from optuna_tpu_torch.gp import optim_mixed

    routes = mo_routes()
    out = {}
    for label, objective, dim, n_obj, n0, asks in routes:
        study = seeded_mo_study(objective, dim, n_obj, n0)
        om = _Spy(optim_mixed, "optimize_acqf_mixed", lambda a, kw, o: (a[0], a[1].box_lowers.shape[0]))
        before = k1_count()
        seconds = []
        try:
            for _ in range(asks):
                t0 = time.perf_counter()
                study.optimize(objective, n_trials=1)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
        finally:
            om.close()
        k1 = k1_count() - before
        check_gp_trials(f"LogEHVI {label}", study, n0, asks)
        if any(c[0] != "logehvi" for c in om.calls) or k1:
            fail(f"LogEHVI {label}: acquisitions {[c[0] for c in om.calls]}, K1 {k1} (expected 0 below n_exact_max)")
        t0 = time.perf_counter()
        kernels, sites = kernels_and_syncs(lambda: study.optimize(objective, n_trials=1))
        trace_s = time.perf_counter() - t0
        card = first_proposal(objective, dim, n_obj, MO_PARITY_FROM, "cuda")
        cpu = twins.get("mo_parity")[label]
        (x_card, v_card), (x_cpu, v_cpu) = card[2], cpu[2]
        gap = float(np.max(np.abs(x_card - x_cpu)))
        if gap > GP_CARD_CPU_TOL:
            if abs(v_card - v_cpu) > GP_TIE * max(1.0, abs(v_cpu)):
                fail(f"LogEHVI {label}: card and CPU proposals {gap:.2e} apart with LogEHVI {v_card:.6f} / "
                     f"{v_cpu:.6f}: not a near tie")
            print(f"LogEHVI {label}: card and CPU proposals part by {gap:.2e} at a near tie of LogEHVI "
                  f"{v_card:.6f} / {v_cpu:.6f}")
        out[label] = {"s": seconds, "boxes": [c[1] for c in om.calls], "kernels": kernels, "sites": sites,
                      "trace_s": trace_s, "gap": gap, "pair_s": (card[3], cpu[3])}
    print(
        "LogEHVI: " + "; ".join(
            f"{label} from {n0} ({n_obj} objectives): boxes {out[label]['boxes']}, seconds per ask "
            f"{[round(x, 3) for x in out[label]['s']]}, one more ask: {out[label]['kernels']} kernels and copies, "
            f"another {sum(out[label]['sites'].values())} synchronizing calls (top lines "
            f"{json.dumps(dict(sorted(out[label]['sites'].items(), key=lambda kv: -kv[1])[:4]))}; traced twice in "
            f"{out[label]['trace_s']:.1f} s); from {MO_PARITY_FROM}: card {out[label]['pair_s'][0]:.3f} s, "
            f"CPU {out[label]['pair_s'][1]:.3f} s, proposals {out[label]['gap']:.2e} apart (normalized)"
            for label, _, _, n_obj, n0, _ in routes
        ) + "; K1 0"
    )
    return out


# ------------------------------------------- phases 29-31: batched trial execution

MLP_BATCH, MLP_WARMUP, MLP_TIMED = 256, 256, 2048  # bench.py --config mlp: batch 256, 256 warm-up, 2048 timed
MLP_STEPS = 10  # bench.py's _MLP_SGD_STEPS
MLP_PROFILED = 2  # batches traced after the timed window, for the device's busy share
# One batch of 256 on the card against CPU torch in float64, trial by trial:
# |card - f64| <= MLP_F64_RTOL * |f64| + 2 * |cpu32 - f64|. Ten SGD steps at a
# rate near 1 amplify float32 rounding: on "NVIDIA H100 80GB HBM3, 700.00 W" the last batch's worst
# trial (lr 0.79, scale 2.79) was 1.24e-2 from float64 in CPU float32 and
# 2.5e-4 on the card, random draws 4.6e-4 and 5.0e-4 (PERF.md, config #5). The
# card may stray as far as CPU float32 does, twice over, plus 1e-3.
MLP_F64_RTOL = 1e-3
FAULT_BATCH, FAULT_TRIALS = 64, 128
NAN_SLOTS = (3, 17, 40)  # phase 30: NaN in the first dispatch at these batch positions
OOM_WIDTH = 16  # phase 30: a trial asks for 0.6 / 16 of the free memory, so 16 fit and 32 do not
HANG_S, DEADLINE_S = 3.0, 1.0  # phase 30: the hung dispatch and the executor's deadline
GP_BATCH, GP_BATCHES, GP_BATCH_FROM = 8, 2, 4000  # phase 31: two batches of 8 from 4000 seeded trials


def mlp_space() -> dict:
    from optuna_tpu_torch.distributions import FloatDistribution

    return {"lr": FloatDistribution(1e-3, 1.0, log=True), "init_scale": FloatDistribution(0.3, 3.0)}


def mlp_problem() -> tuple[np.ndarray, np.ndarray, dict]:
    """``bench.py::_mlp_problem``: ``RandomState(0)``'s 256 x 784 inputs, 10
    classes and the initial weights at hidden width 32."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(256, 784)).astype(np.float32)
    y = rng.randint(0, 10, 256).astype(np.int32)
    init = {
        "w1": rng.normal(0, 0.1, (784, 32)).astype(np.float32),
        "b1": np.zeros(32, np.float32),
        "w2": rng.normal(0, 0.1, (32, 10)).astype(np.float32),
        "b2": np.zeros(10, np.float32),
    }
    return x, y, init


def mlp_objective_fn(device, dtype=None):
    """Config #5's batched objective on ``device``: ``bench.py::_mlp_problem``'s
    data and initial weights (``RandomState(0)``: 256 examples of 784
    inputs, 10 classes, hidden width 32); trial ``i`` trains ``base *
    init_scale[i]`` for 10 SGD steps at rate ``lr[i]`` and returns the final
    loss. ``dtype=torch.float64`` gives the oracle of the float32 program."""
    import torch

    from optuna_tpu_torch.models.mlp import MLPParams, mlp_params_from_numpy, train_scaled_batch

    x, y, init = mlp_problem()
    dtype = dtype or torch.float32
    base = MLPParams(*(p.to(dtype) for p in mlp_params_from_numpy(init, device)))
    tx, ty = torch.from_numpy(x).to(device, dtype), torch.from_numpy(y).to(device)

    def fn(params):
        return train_scaled_batch(base, tx, ty, params["lr"], params["init_scale"], MLP_STEPS)

    return fn


def mlp_flops_per_trial() -> int:
    """``bench.py:1157-1160``'s count: a forward pass is 256 x (784 x 32 + 32 x
    10) multiply-adds, a value-and-grad step three forwards, and the final
    loss one more."""
    macs = 256 * (784 * 32 + 32 * 10)
    return 2 * macs * (3 * MLP_STEPS + 1)


def check_all_complete(label: str, study, n: int) -> None:
    import optuna_tpu_torch as ot

    trials = study.get_trials(deepcopy=False)
    done = [t for t in trials if t.state == ot.TrialState.COMPLETE]
    if len(trials) != n or len(done) != n:
        fail(f"{label}: {len(done)} of {len(trials)} trials COMPLETE, expected {n}")
    if not all(in_distributions(t) and all(math.isfinite(v) for v in t.values) for t in done):
        fail(f"{label}: a trial is non-finite or outside its distributions")


def phase_mlp(gpu: str) -> dict:
    """BASELINE config #5 as ``bench.py::run_ours_mlp_vectorized`` runs it:
    ``TPESampler(seed=0, multivariate=True, constant_liar=True,
    n_startup_trials=10)``, batches of 256 through ``optimize_vectorized``,
    256 warm-up trials and 2048 timed, once on the card. Two seeded runs of
    this ``train_scaled_batch`` path are no longer held to each other on the
    card; phase 36(a) holds two seeded runs of config #5's sharded form
    (the one-hot loss) to each other."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch import telemetry
    from optuna_tpu_torch.parallel import VectorizedObjective, optimize_vectorized
    from optuna_tpu_torch.samplers import TPESampler

    device = torch.device("cuda", 0)
    fn = mlp_objective_fn(device)
    study = ot.create_study(sampler=TPESampler(seed=0, multivariate=True, constant_liar=True, n_startup_trials=10))
    objective = VectorizedObjective(fn, mlp_space())
    t0 = time.perf_counter()
    optimize_vectorized(study, objective, MLP_WARMUP, batch_size=MLP_BATCH)
    warm_s = time.perf_counter() - t0
    registry = telemetry.MetricsRegistry()
    telemetry.enable(registry)
    try:
        t1 = time.perf_counter()
        optimize_vectorized(study, objective, MLP_TIMED, batch_size=MLP_BATCH)
        timed_s = time.perf_counter() - t1  # every batch's tells read its values: the card has finished
    finally:
        telemetry.disable()
    phases = telemetry.phase_totals(registry.snapshot())
    check_all_complete("config #5", study, MLP_WARMUP + MLP_TIMED)

    # One warm batch's device time and the card against CPU torch, on the
    # last batch's params.
    last = study.get_trials(deepcopy=False)[-MLP_BATCH:]
    packed = {k: np.asarray([d.to_internal_repr(t.params[k]) for t in last], np.float32) for k, d in mlp_space().items()}
    args = {k: torch.from_numpy(v).to(device) for k, v in packed.items()}
    batch_ms = cuda_ms(lambda: fn(args), reps=20)
    card = fn(args).cpu().numpy().astype(np.float64)
    host = {k: torch.from_numpy(v) for k, v in packed.items()}
    cpu32 = mlp_objective_fn(torch.device("cpu"))(host).numpy().astype(np.float64)
    cpu64 = mlp_objective_fn(torch.device("cpu"), torch.float64)(host).numpy()
    told = np.array([t.value for t in last], dtype=np.float64)
    allowed = MLP_F64_RTOL * np.abs(cpu64) + 2.0 * np.abs(cpu32 - cpu64)
    rel = lambda a: float(np.max(np.abs(a - cpu64) / np.abs(cpu64)))  # noqa: E731
    if not (np.isfinite(card).all() and np.all(np.abs(card - cpu64) <= allowed)):
        worst = int(np.argmax(np.abs(card - cpu64) - allowed))
        fail(f"config #5: trial {last[worst].number} of the last batch is {card[worst]} on the card, {cpu32[worst]} in "
             f"CPU float32, {cpu64[worst]} in CPU float64: beyond {MLP_F64_RTOL} of float64 plus twice CPU float32's "
             "error")
    told_diff = float(np.max(np.abs(card - told)))

    # Synchronizing calls of one more batch, by line: the executor's must be
    # the dispatch's one read.
    sites = sync_sites(lambda: optimize_vectorized(study, objective, MLP_BATCH, batch_size=MLP_BATCH))
    in_executor = sum(v for k, v in sites.items() if k.startswith("optuna_tpu_torch/parallel/executor.py"))
    if in_executor != 1:
        fail(f"config #5: a batch made {in_executor} synchronizing calls in the executor, expected its one read: {sites}")
    # The device's busy share, from a trace of a few more batches.
    wall_ms, busy_ms, kernels, dtoh, syncs = profiled(
        "config 5 batches",
        lambda: optimize_vectorized(study, objective, MLP_PROFILED * MLP_BATCH, batch_size=MLP_BATCH),
    )
    n_batches = MLP_TIMED // MLP_BATCH
    flops_batch = mlp_flops_per_trial() * MLP_BATCH
    out = {
        "trials_per_s": MLP_TIMED / timed_s,
        "batch_ms": batch_ms,
        "gflops": flops_batch / (batch_ms * 1e-3) / 1e9,
        "duty": batch_ms * 1e-3 * n_batches / timed_s,
        "busy": busy_ms / wall_ms,
        "best": study.best_value,
    }
    per_batch = ", ".join(f"{k} {v['total_s'] / v['count'] * 1e3:.2f} ms" for k, v in phases.items())
    print(
        f"phase 29, config #5 (256-way MLP, TPESampler(seed=0, multivariate, constant_liar, n_startup_trials=10), "
        f"batches of {MLP_BATCH}; {gpu}): {MLP_WARMUP} warm-up trials in {warm_s:.3f} s, then "
        f"{MLP_TIMED} timed: {out['trials_per_s']:.1f} trials/s (host clock, one seeded run); per batch "
        f"{per_batch} ({n_batches} batches); one warm batch {batch_ms:.4f} ms on the device (CUDA events, {MLP_BATCH} trials "
        f"x 10 SGD steps, {flops_batch / 1e9:.2f} GFLOP): {out['gflops']:.1f} GFLOP/s; duty cycle {out['duty']:.4f} "
        f"(that batch time x {n_batches} over the timed window, bench.py's estimate); device busy {out['busy']:.4f} "
        f"over {MLP_PROFILED} traced batches ({kernels} kernels, {dtoh} device-to-host copies, {syncs} stream syncs); "
        f"synchronizing calls of one batch by line {sites}; "
        f"the last batch against CPU float64: card {rel(card):.3e}, CPU float32 {rel(cpu32):.3e} (relative, worst "
        f"trial; allowed {MLP_F64_RTOL} plus twice CPU float32's error), the told values against the card's "
        f"recompute {told_diff:.3e}; best {out['best']:.6f}"
    )
    return out


SHARDED_BATCH, SHARDED_WARMUP, SHARDED_TIMED = 256, 256, 512  # phase 36(a): bench.py --loop=sharded at 1 x 1
SHARDED_RULES = [("w1", (None, "model")), ("b1", ("model",)), ("w2", ("model", None)), (".*", ())]
POD_RANKS, POD_BATCH, POD_BATCHES = 2, 16, 4  # phase 36(b): {'trials': 2, 'model': 1}, 4 batches of 16
POD_POISON = (2, 11)  # (dispatch, row): batch 2's first dispatch, row 11 = shard t1's fourth row
POD_VALUE_RTOL = 1e-5  # the pod's ranks multiply 8 rows where the 1 x 1 twin multiplies 16 (another GEMM shape)
POD_TIMEOUT_S = 300


def sharded_mlp_parts(device):
    """Config #5 as ``bench.py::_sharded_mlp_objective`` writes it, in torch:
    the ``ShardedObjective`` (its model the rules' ``DTensor`` s, the data
    replicated on the mesh) and the same training on plain tensors, the fn
    of its ``optimize_vectorized`` twin. One function,
    ``models.mlp.train_scaled_batch`` with ``cross_entropy_onehot``, runs
    both."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from optuna_tpu_torch.models.mlp import (
        MLPParams,
        cross_entropy_onehot,
        mlp_params_from_numpy,
        train_scaled_batch,
    )
    from optuna_tpu_torch.parallel import ShardedObjective

    x, y, init = mlp_problem()
    tx = torch.from_numpy(x).to(device)
    onehot = torch.eye(10, device=device)[torch.from_numpy(y).long().to(device)]
    base = mlp_params_from_numpy(init, device)

    def plain(params):
        return train_scaled_batch(
            base, tx, onehot, params["lr"], params["init_scale"], MLP_STEPS, cross_entropy_onehot
        )

    def sharded(params, m):
        mesh = m["w1"].device_mesh
        rep = [Replicate()] * mesh.ndim
        dx = DTensor.from_local(tx, mesh, rep, run_check=False)
        doh = DTensor.from_local(onehot, mesh, rep, run_check=False)
        model = MLPParams(m["w1"], m["b1"], m["w2"], m["b2"])
        return train_scaled_batch(
            model, dx, doh, params["lr"], params["init_scale"], MLP_STEPS, cross_entropy_onehot
        )

    return ShardedObjective(sharded, mlp_space(), model=init, partition_rules=SHARDED_RULES), plain


def sharded_twins(mesh, warmup: int, timed: int, batch: int) -> dict:
    """Phase 36(a)'s two runs of config #5's study on the card, the sharded
    one and its ``optimize_vectorized`` twin, each ``warmup`` + ``timed``
    trials in batches of ``batch``; fails unless they are identical trial
    for trial."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import VectorizedObjective, optimize_sharded, optimize_vectorized
    from optuna_tpu_torch.samplers import TPESampler

    objective, plain = sharded_mlp_parts(torch.device("cuda", 0))
    twin_objective = VectorizedObjective(plain, mlp_space())
    runs: dict = {"objective": objective}
    for name in ("sharded", "twin"):
        study = ot.create_study(
            sampler=TPESampler(seed=0, multivariate=True, constant_liar=True, n_startup_trials=10)
        )
        if name == "sharded":
            step = lambda n: optimize_sharded(study, objective, n, batch_size=batch, mesh=mesh)  # noqa: E731
        else:
            step = lambda n: optimize_vectorized(study, twin_objective, n, batch_size=batch)  # noqa: E731
        t0 = time.perf_counter()
        step(warmup)
        warm_s = time.perf_counter() - t0
        batch_s = []
        for _ in range(timed // batch):  # a call a batch, for each batch's seconds
            t1 = time.perf_counter()
            step(batch)  # every batch's tells read its values: the card has finished
            batch_s.append(time.perf_counter() - t1)
        runs[name] = {"study": study, "warm_s": warm_s, "timed_s": sum(batch_s), "batch_s": batch_s}
        check_all_complete(f"phase 36(a) {name}", study, warmup + timed)
    if trial_rows(runs["sharded"]["study"]) != trial_rows(runs["twin"]["study"]):
        fail("phase 36(a): the sharded run and its optimize_vectorized twin differ")
    return runs


class PoisonRow:
    """A ``raise_when`` predicate: at dispatch ``dispatch`` the trial in row
    ``row`` becomes the poison (by its ``lr``), and every dispatch whose
    batch holds it raises, so the poison follows its trial through the
    containment's re-dispatches on every rank alike."""

    def __init__(self, dispatch: int, row: int) -> None:
        self.dispatch, self.row, self.seen, self.value = dispatch, row, 0, None

    def __call__(self, host: dict) -> bool:
        if self.seen == self.dispatch:
            self.value = host["lr"][self.row]
        self.seen += 1
        return self.value is not None and bool(np.any(host["lr"] == self.value))


def pod_objective(device=None):
    import torch

    from optuna_tpu_torch.testing.fault_injection import FaultyVectorizedObjective

    _, plain = sharded_mlp_parts(torch.device("cuda", 0) if device is None else torch.device(device))
    return FaultyVectorizedObjective(plain, mlp_space(), raise_when=PoisonRow(*POD_POISON))


def pod_study(mesh, rank: int, device=None) -> tuple:
    """Phase 36(b)'s run on one rank (or, with one rank, its twin):
    ``RandomSampler(seed=0)`` over ``JournalStorage(IciJournalBackend())``,
    ``POD_BATCHES`` batches of ``POD_BATCH`` through ``optimize_sharded``."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import IciJournalBackend, optimize_sharded
    from optuna_tpu_torch.samplers import RandomSampler
    from optuna_tpu_torch.storages.journal import JournalStorage

    backend = IciJournalBackend()
    storage = JournalStorage(backend)
    if rank == 0:
        storage.create_new_study([ot.StudyDirection.MINIMIZE], study_name="pod")
    else:
        backend.exchange()  # the leader's create
    study = ot.load_study(study_name="pod", storage=storage, sampler=RandomSampler(seed=0))
    objective = pod_objective(device)
    t0 = time.perf_counter()
    optimize_sharded(study, objective, POD_BATCH * POD_BATCHES, batch_size=POD_BATCH, mesh=mesh, device=device)
    return study, backend, objective, time.perf_counter() - t0


def _pod_rank(rank: int, tmp: str, go, queue) -> None:
    """One rank of phase 36(b): imports torch and the port and joins the
    gloo group at the script's start (niced, as the CPU twins' helper is),
    then waits for the phase. It touches the card only then: an idle CUDA
    context costs the card's host ~0.15 of a core a rank (``PERF.md``)."""
    import torch.distributed as dist

    try:
        os.nice(10)
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/pg", rank=rank, world_size=POD_RANKS,
            timeout=datetime.timedelta(seconds=POD_TIMEOUT_S),
        )
        import importlib

        import optuna_tpu_torch
        from optuna_tpu_torch.parallel import build_study_mesh

        optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.ERROR)
        wrappers = [importlib.import_module(k["module"]) for k in KERNELS]
        if not go.wait(timeout=3600):
            return
        mesh = build_study_mesh({"trials": POD_RANKS, "model": 1}, device="cpu")
        study, backend, objective, seconds = pod_study(mesh, rank, device="cuda")
        launches = sum(getattr(w, k.get("counter", "LAUNCHES")) for w, k in zip(wrappers, KERNELS))
        queue.put((rank, True, {
            "rows": trial_rows(study), "logs": backend.read_logs(0), "widths": objective.dispatch_widths,
            "seconds": seconds, "launches": launches,
        }))
    except BaseException:  # reported to the phase, which fails
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class PodRanks:
    """Phase 36(b)'s two ranks, started with the script (``spawn``) so that
    their start-up (torch, the port, the group) overlaps the other phases;
    :meth:`run` starts the pod and returns each rank's result."""

    def __init__(self) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="chip_smoke_pod_")
        self._go = ctx.Event()
        self._queue = ctx.Queue()
        self._procs = [
            ctx.Process(target=_pod_rank, args=(r, self._dir, self._go, self._queue), daemon=True)
            for r in range(POD_RANKS)
        ]
        for proc in self._procs:
            proc.start()

    def run(self) -> list[dict]:
        import queue

        self._go.set()
        out: dict = {}
        deadline = time.monotonic() + POD_TIMEOUT_S
        while len(out) < POD_RANKS:
            try:
                rank, ok, value = self._queue.get(timeout=5.0)
            except queue.Empty:
                if time.monotonic() > deadline or not all(p.is_alive() for p in self._procs):
                    self.close()
                    fail(f"phase 36(b): the pod's ranks ended or hung (exit codes {[p.exitcode for p in self._procs]})")
                continue
            if not ok:
                self.close()
                fail(f"phase 36(b): rank {rank} raised:\n{value}")
            out[rank] = value
        self.close()
        return [out[r] for r in range(POD_RANKS)]

    def close(self) -> None:
        for proc in self._procs:
            proc.join(timeout=10.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10.0)
        shutil.rmtree(self._dir, ignore_errors=True)


def pod_widths() -> list[int]:
    """The dispatch widths phase 36(b)'s pod must make: batches 0-1 whole;
    batch 2 fails and splits into its two shard groups (t0's 8 rows complete
    in one re-dispatch), then the bisection stays inside t1's rows down to
    the poison, each narrower dispatch padded to the 2 shards; batch 3
    whole."""
    return [16, 16, 16, 8, 8, 4, 2, 2, 2, 2, 4, 16]


def phase_sharded(pod: PodRanks, gpu: str) -> dict:
    """Phase 36: the sharded tier on the card (see the module docstring)."""
    import torch.distributed as dist

    from optuna_tpu_torch.parallel import build_study_mesh, optimize_sharded

    t_start = time.perf_counter()
    out: dict = {}
    mesh = build_study_mesh({"trials": 1, "model": 1})
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        fail(f"phase 36: the 1 x 1 mesh is {mesh.device_type} over {dist.get_backend()}, expected cuda over nccl")

    # (a) config #5's sharded MLP and its optimize_vectorized twin.
    runs = sharded_twins(mesh, SHARDED_WARMUP, SHARDED_TIMED, SHARDED_BATCH)
    objective = runs["objective"]
    placed, _ = objective.sharded_model(mesh)
    layout = {k: (str(placed[k].placements), tuple(placed[k].to_local().shape)) for k in ("w1", "b1", "w2")}
    if tuple(placed["w1"].to_local().shape) != (784, 32) or any(v.device.type != "cuda" for v in placed.values()):
        fail(f"phase 36(a): the model's DTensors are not where the 1 x 1 mesh puts them: {layout}")
    study = runs["sharded"]["study"]
    wall_ms, busy_ms, kernels, _, _ = profiled(
        "sharded batch", lambda: optimize_sharded(study, objective, SHARDED_BATCH, batch_size=SHARDED_BATCH, mesh=mesh)
    )
    out["a"] = {
        "trials_per_s": {k: SHARDED_TIMED / runs[k]["timed_s"] for k in ("sharded", "twin")},
        "overhead_s": runs["sharded"]["timed_s"] - runs["twin"]["timed_s"],
        "busy": busy_ms / wall_ms,
        "best": study.best_value,
    }
    print(
        f"phase 36(a), config #5 sharded (bench.py --loop=sharded at a 1 x 1 mesh, NCCL on a one-rank HashStore "
        f"group; {gpu}): {SHARDED_WARMUP} warm-up trials in {runs['sharded']['warm_s']:.3f} s (twin "
        f"{runs['twin']['warm_s']:.3f}), then {SHARDED_TIMED} timed in batches of {SHARDED_BATCH}: "
        f"{out['a']['trials_per_s']['sharded']:.1f} trials/s through optimize_sharded, "
        f"{out['a']['trials_per_s']['twin']:.1f} through its optimize_vectorized twin (host clock; identical trial "
        f"for trial); DTensor overhead {out['a']['overhead_s']:.3f} s over the timed window "
        f"({out['a']['overhead_s'] / (SHARDED_TIMED / SHARDED_BATCH) * 1e3:.1f} ms a batch; the timed batches "
        f"{', '.join(f'{x:.3f}' for x in runs['sharded']['batch_s'])} s, the twin's "
        f"{', '.join(f'{x:.3f}' for x in runs['twin']['batch_s'])}); device busy "
        f"{out['a']['busy']:.4f} over one more warm batch ({wall_ms:.1f} ms wall, {busy_ms:.1f} ms busy, {kernels} "
        f"kernels); placements and local shapes {layout}; best {out['a']['best']:.6f}"
    )

    # (b) the two-rank pod, and its one-process twin at 1 x 1.
    import optuna_tpu_torch as ot

    ranks = pod.run()
    verbosity = ot.logging.get_verbosity()
    ot.logging.set_verbosity(ot.logging.ERROR)  # the poison's containment logs a warning a step
    try:
        twin, _, _, twin_s = pod_study(mesh, 0)
    finally:
        ot.logging.set_verbosity(verbosity)
    lead = ranks[0]
    if ranks[1]["rows"] != lead["rows"] or ranks[1]["logs"] != lead["logs"]:
        fail("phase 36(b): the two ranks' studies or merged logs differ")
    if any(r["widths"] != pod_widths() for r in ranks):
        fail(f"phase 36(b): dispatch widths {[r['widths'] for r in ranks]}, expected {pod_widths()} on both ranks")
    poison = POD_POISON[0] * POD_BATCH + POD_POISON[1]
    states = {number: state for number, state, _, _ in lead["rows"]}
    if sorted(states) != list(range(POD_BATCH * POD_BATCHES)) or [n for n, st in states.items() if st != "COMPLETE"] != [
        poison
    ] or states[poison] != "FAIL":
        fail(f"phase 36(b): states {states}, expected trial {poison} FAIL and every other trial COMPLETE once")
    twin_rows = trial_rows(twin)
    if len(twin_rows) != len(lead["rows"]):
        fail(f"phase 36(b): the twin has {len(twin_rows)} trials, the pod {len(lead['rows'])}")
    worst = 0.0
    for (n, st, params, values), (tn, tst, tparams, tvalues) in zip(lead["rows"], twin_rows):
        rel = 0.0 if values is None or tvalues is None else abs(values[0] - tvalues[0]) / abs(tvalues[0])
        worst = max(worst, rel)
        if (n, st, params) != (tn, tst, tparams) or (values is None) != (tvalues is None) or rel > POD_VALUE_RTOL:
            fail(f"phase 36(b): trial {n} of the pod {st} {params} {values}, of the 1 x 1 twin {tst} {tparams} {tvalues}")
    if any(r["launches"] for r in ranks):
        fail(f"phase 36(b): the pod's ranks launched kernels of the repo: {[r['launches'] for r in ranks]}")
    out["b"] = {"seconds": [r["seconds"] for r in ranks], "twin_s": twin_s, "worst_rel": worst}
    dist.destroy_process_group()
    out["s"] = time.perf_counter() - t_start
    print(
        f"phase 36(b), a two-rank pod on one card ({gpu}): mesh {{'trials': 2, 'model': 1}} over gloo, "
        f"JournalStorage(IciJournalBackend()), {POD_BATCHES} batches of {POD_BATCH}, poison at trial {poison}: "
        f"{out['b']['seconds'][0]:.3f} / {out['b']['seconds'][1]:.3f} s on ranks 0 / 1, the 1 x 1 twin "
        f"{twin_s:.3f} s; widths {lead['widths']}; only trial {poison} FAIL; {len(lead['logs'])} journal ops, equal "
        f"on both ranks; values against the twin within {worst:.3e} (relative); phase 36 {out['s']:.1f} s"
    )
    return out

def states_of(study) -> dict:
    counts: dict = {}
    for t in study.get_trials(deepcopy=False):
        counts[t.state.name] = counts.get(t.state.name, 0) + 1
    return counts


def phase_containment() -> dict:
    """The executor's containment on the card, around config #5's objective,
    ``RandomSampler`` studies: NaN under each ``non_finite`` policy, a
    persistent poison trial, a real out-of-memory error of the card, and a
    hung dispatch under a deadline. No case may leave a trial RUNNING."""
    import torch

    import optuna_tpu_torch as ot

    fn = mlp_objective_fn(torch.device("cuda", 0))
    space = mlp_space()
    out: dict = {}
    verbosity = ot.logging.get_verbosity()
    ot.logging.set_verbosity(ot.logging.ERROR)  # each contained fault logs a warning
    try:
        _containment_cases(fn, space, out)
    finally:
        ot.logging.set_verbosity(verbosity)
    return out


def _containment_cases(fn, space: dict, out: dict) -> None:
    import threading

    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch.parallel import NonFiniteObjectiveError, VectorizedObjective, optimize_vectorized
    from optuna_tpu_torch.samplers import RandomSampler
    from optuna_tpu_torch.storages import RetryPolicy
    from optuna_tpu_torch.testing.fault_injection import FaultyVectorizedObjective

    def study(seed: int):
        return ot.create_study(sampler=RandomSampler(seed=seed))

    def run(label: str, st, objective, n: int, **kwargs) -> dict:
        t0 = time.perf_counter()
        raised = None
        try:
            optimize_vectorized(st, objective, n, batch_size=FAULT_BATCH,
                                retry_policy=RetryPolicy(max_attempts=5, sleep=lambda _s: None), **kwargs)
        except NonFiniteObjectiveError as err:
            raised = err
        counts = states_of(st)
        if counts.get("RUNNING"):
            fail(f"containment {label}: {counts['RUNNING']} trials left RUNNING")
        widths = getattr(objective, "dispatch_widths", None)
        out[label] = {"states": counts, "widths": widths, "s": time.perf_counter() - t0, "raised": raised}
        return out[label]

    def failed(st) -> list[int]:
        return [t.number for t in st.get_trials(deepcopy=False) if t.state == ot.TrialState.FAIL]

    for policy in ("fail", "raise", "clip"):
        st = study(0)
        r = run(f"nan/{policy}", st, FaultyVectorizedObjective(fn, space, nan_at={0: NAN_SLOTS}), FAULT_TRIALS,
                non_finite=policy)
        if policy == "fail" and (failed(st) != list(NAN_SLOTS) or r["states"]["COMPLETE"] != FAULT_TRIALS - 3):
            fail(f"containment nan/fail: FAIL {failed(st)}, states {r['states']}")
        if policy == "raise" and (r["raised"] is None or failed(st) != list(NAN_SLOTS)
                                  or r["states"]["COMPLETE"] != FAULT_BATCH - 3):
            fail(f"containment nan/raise: raised {r['raised']!r}, FAIL {failed(st)}, states {r['states']}")
        if policy == "clip":
            values = [t.value for t in st.get_trials(deepcopy=False)]
            if r["states"] != {"COMPLETE": FAULT_TRIALS} or any(values[i] != 0.0 for i in NAN_SLOTS):
                fail(f"containment nan/clip: states {r['states']}, poisoned values {[values[i] for i in NAN_SLOTS]}")

    # A persistent poison: the enqueued trial's rate crashes every dispatch that holds it.
    st = study(1)
    st.enqueue_trial({"lr": 0.999, "init_scale": 1.0})
    poison = FaultyVectorizedObjective(fn, space, raise_when=lambda host: bool((host["lr"] > 0.99).any()))
    r = run("poison", st, poison, FAULT_BATCH)
    if failed(st) != [0] or r["states"].get("COMPLETE") != FAULT_BATCH - 1:
        fail(f"containment poison: FAIL {failed(st)}, states {r['states']}, expected trial 0 alone")

    # A real out-of-memory error: OOM_WIDTH trials ask for 0.6 of the free
    # memory, twice as many for more than the card holds. The widths must be
    # those of the fault kit's stand-in (oom_above=OOM_WIDTH) on the same
    # schedule, whose widths are powers of two.
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    per_trial = int(0.6 * free / OOM_WIDTH)
    ooms = []

    def hungry(params):
        width = params["lr"].shape[0]
        try:
            scratch = torch.empty(width * per_trial, dtype=torch.uint8, device=params["lr"].device)
        except torch.OutOfMemoryError:
            ooms.append(width)
            raise
        del scratch
        return fn(params)

    widths: list[int] = []
    real = VectorizedObjective(lambda p: (widths.append(p["lr"].shape[0]), hungry(p))[1], space)
    r = run("oom", study(2), real, FAULT_TRIALS * 2)
    r["widths"], r["ooms"] = widths, ooms
    stand_in = FaultyVectorizedObjective(fn, space, oom_above=OOM_WIDTH)
    run("oom stand-in", study(2), stand_in, FAULT_TRIALS * 2)
    torch.cuda.empty_cache()
    if not ooms or widths != stand_in.dispatch_widths or r["states"] != {"COMPLETE": FAULT_TRIALS * 2}:
        fail(f"containment oom: widths {widths} ({len(ooms)} torch.OutOfMemoryError), stand-in "
             f"{stand_in.dispatch_widths}, states {r['states']}")
    if max(widths[widths.index(OOM_WIDTH) + 1:], default=0) <= OOM_WIDTH:
        fail(f"containment oom: the batch never regrew past {OOM_WIDTH} after clean batches: {widths}")

    # A hung dispatch: the deadline abandons it, bisection salvages the batch.
    hang = FaultyVectorizedObjective(fn, space, hang_at={1}, hang_s=HANG_S)
    r = run("hang", study(3), hang, FAULT_BATCH * 2, dispatch_deadline_s=DEADLINE_S)
    if r["states"] != {"COMPLETE": FAULT_BATCH * 2} or hang.dispatch_widths[:4] != [FAULT_BATCH] * 2 + [FAULT_BATCH // 2] * 2:
        fail(f"containment hang: widths {hang.dispatch_widths}, states {r['states']}")
    for thread in threading.enumerate():  # the abandoned dispatch finishes before the next phase
        if thread.name == "optuna-tpu-dispatch":
            thread.join(timeout=HANG_S + 30.0)
    torch.cuda.synchronize()
    print(
        f"phase 30, containment on the card (config #5's objective, RandomSampler, batches of {FAULT_BATCH}): "
        + "; ".join(
            f"{k}: {v['states']}" + (f", widths {v['widths']}" if v["widths"] is not None else "")
            + (f", raised {type(v['raised']).__name__}" if v["raised"] is not None else "") + f", {v['s']:.2f} s"
            for k, v in out.items()
        )
        + f"; real OOM: {len(ooms)} torch.OutOfMemoryError at widths {ooms} ({per_trial / 2**30:.2f} GiB a trial of "
        f"{free / 2**30:.1f} GiB free)"
    )


def phase_gp_batches(k1_count) -> dict:
    """GPSampler through the batch executor: Hartmann-20D
    (``models.benchmarks.hartmann20_torch``) from 4000 seeded trials, two
    batches of 8 through ``optimize_vectorized``. Each batch is one sparse
    ``sample_relative_batch``: K1 launches once a batch."""
    import torch

    from optuna_tpu_torch.models.benchmarks import hartmann20_torch
    from optuna_tpu_torch.parallel import VectorizedObjective, optimize_vectorized

    study = seeded_study(GP_BATCH_FROM)
    objective = VectorizedObjective(hartmann20_torch, hartmann_space())
    before = k1_count()
    t0 = time.perf_counter()
    optimize_vectorized(study, objective, GP_BATCH * GP_BATCHES, batch_size=GP_BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = k1_count() - before
    check_gp_trials("GP batches", study, GP_BATCH_FROM, GP_BATCH * GP_BATCHES)
    if k1 != GP_BATCHES:
        fail(f"GP batches: K1 launched {k1} times over {GP_BATCHES} sparse batch asks, expected once each")
    trials = study.get_trials(deepcopy=False)[GP_BATCH_FROM:]
    distinct = len({tuple(t.params.values()) for t in trials})
    print(
        f"phase 31, GPSampler(seed=0) batches through optimize_vectorized (Hartmann-20D from {GP_BATCH_FROM}): "
        f"{GP_BATCHES} batches of {GP_BATCH} in {seconds:.3f} s ({seconds / GP_BATCHES:.3f} s a batch, "
        f"{seconds / (GP_BATCH * GP_BATCHES) * 1e3:.1f} ms a trial), K1 {k1}, {distinct} distinct points, best "
        f"{study.best_value:.6f}"
    )
    return {"k1": k1, "s": seconds}


RESUME_HISTORY = 1100  # 1100 + 96 trials: bucket 2048, above n_exact_max 1024, so every chunk is SGPR
RESUME_TRIALS = 96
RESUME_SYNC = 32
RESUME_KILL_AT = 44  # set_trial_state_values call index: the 13th tell of the second chunk


def scan_run(label: str, fn) -> tuple[float, dict, dict, dict]:
    """``fn()`` under a fresh telemetry registry: (host seconds to the card's
    last op, phase totals, counters, device stats)."""
    import torch

    from optuna_tpu_torch import device_stats, telemetry

    telemetry.enable(telemetry.MetricsRegistry())
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        snap = telemetry.snapshot()
        return seconds, telemetry.phase_totals(), snap["counters"], device_stats.stat_gauges()
    finally:
        telemetry.disable()


def phase_resume(k1_count) -> dict:
    """Phase 32 (see the module docstring)."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch import checkpoint
    from optuna_tpu_torch.parallel import optimize_scan
    from optuna_tpu_torch.samplers import RandomSampler
    from optuna_tpu_torch.storages import JournalFileBackend, JournalStorage
    from optuna_tpu_torch.testing.fault_injection import FaultInjectorStorage, FaultPlan, SimulatedWorkerDeath

    objective = scan_objective()
    kwargs = dict(sync_every=RESUME_SYNC, seed=0, n_exact_max=1024, n_inducing=256)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        journal = os.path.join(tmp, "resume.journal")
        sqlite_url = f"sqlite:///{os.path.join(tmp, 'twin.db')}"
        history = history_trials(RESUME_HISTORY)
        seed_s = {}
        for name, storage in (("journal", JournalStorage(JournalFileBackend(journal))), ("sqlite", sqlite_url)):
            t0 = time.perf_counter()
            ot.create_study(storage=storage, study_name="resume", sampler=RandomSampler(seed=0)).add_trials(history)
            seed_s[name] = time.perf_counter() - t0

        def load(storage):
            return ot.load_study(study_name="resume", storage=storage, sampler=RandomSampler(seed=0))

        injector = FaultInjectorStorage(
            JournalStorage(JournalFileBackend(journal)),
            FaultPlan(kill_schedule={"set_trial_state_values": (RESUME_KILL_AT,)}),
        )
        killed = load(injector)
        k1_before = k1_count()

        def kill_run():
            try:
                optimize_scan(killed, objective, RESUME_TRIALS, **kwargs)
            except SimulatedWorkerDeath:
                return
            fail("resume: the scheduled kill never struck")

        kill_s, kill_phases, _, kill_g = scan_run("killed", kill_run)
        k1_kill = k1_count() - k1_before
        resumed = load(JournalStorage(JournalFileBackend(journal)))  # a new process's storage object
        k1_before = k1_count()
        resume_s, resume_phases, resume_c, resume_g = scan_run(
            "resumed", lambda: optimize_scan(resumed, objective, RESUME_TRIALS, resume=True, **kwargs)
        )
        k1_resume = k1_count() - k1_before
        twin = load(sqlite_url)
        k1_before = k1_count()
        twin_s, twin_phases, _, twin_g = scan_run("twin", lambda: optimize_scan(twin, objective, RESUME_TRIALS, **kwargs))
        k1_twin = k1_count() - k1_before
        resumed_trials = load(JournalStorage(JournalFileBackend(journal))).get_trials(deepcopy=False)[RESUME_HISTORY:]
        twin_trials = twin.get_trials(deepcopy=False)[RESUME_HISTORY:]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    told = [t for t in resumed_trials if t.state.is_finished() and checkpoint.OP_TOKEN_ATTR in t.system_attrs
            and checkpoint.STRANDED_ATTR not in t.system_attrs]
    tokens = [t.system_attrs[checkpoint.OP_TOKEN_ATTR] for t in resumed_trials if checkpoint.OP_TOKEN_ATTR in t.system_attrs]
    running = sum(t.state == ot.TrialState.RUNNING for t in resumed_trials)
    if len(told) != RESUME_TRIALS or running or len(tokens) != len(set(tokens)):
        fail(f"resume: {len(told)} budget-consuming tells (expected {RESUME_TRIALS}), {running} RUNNING, "
             f"{len(tokens) - len(set(tokens))} op tokens told twice")
    if resume_c.get("checkpoint.restore", 0) != 1 or resume_c.get("checkpoint.fallback", 0):
        fail(f"resume: checkpoint counters {resume_c}, expected one restore and no fallback")
    got = [(t.params, t.values) for t in resumed_trials if t.state == ot.TrialState.COMPLETE]
    want = [(t.params, t.values) for t in twin_trials if t.state == ot.TrialState.COMPLETE]
    if len(want) != RESUME_TRIALS or got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        fail(f"resume: the resumed study parts from its twin at trial {first} ({len(got)} and {len(want)} COMPLETE)")

    def chunks(phases):
        return int(phases.get("scan.chunk", {}).get("count", 0))

    def swaps(g):
        return int(g.get("device.gp.inducing_swaps.total", 0))

    # The killed run dispatched its third chunk and died syncing the second,
    # so the device stats hold its first two chunks only. The third chunk's
    # swap-ins are the twin's total less those two chunks' (the killed run's
    # first chunks are the twin's: the trial equality above holds them).
    want_k1 = {
        "killed": chunks(kill_phases) + swaps(kill_g) + (swaps(twin_g) - swaps(kill_g)),
        "resumed": chunks(resume_phases) + swaps(resume_g),
        "twin": chunks(twin_phases) + swaps(twin_g),
    }
    got_k1 = {"killed": k1_kill, "resumed": k1_resume, "twin": k1_twin}
    if (chunks(kill_phases), chunks(resume_phases), chunks(twin_phases)) != (3, 2, 3) or got_k1 != want_k1:
        fail(f"resume: K1 launched {got_k1}, expected {want_k1} (chunks and swap-ins from the device stats)")
    restore_s = resume_phases.get("ckpt.restore", {}).get("total_s", 0.0)
    print(
        f"phase 32, preempt and resume config #2's scan (Hartmann-20D, {RESUME_HISTORY} seeded + {RESUME_TRIALS}, "
        f"sync_every {RESUME_SYNC}, m 256, bucket 2048): seeding {seed_s['journal']:.3f} s journal file / "
        f"{seed_s['sqlite']:.3f} s sqlite; killed run {kill_s:.3f} s ({chunks(kill_phases)} chunks, killed at tell "
        f"{RESUME_KILL_AT + 1}); resume {resume_s:.3f} s ({chunks(resume_phases)} chunks; restore {restore_s:.4f} s: "
        f"load, validate, classify, reap); twin on sqlite {twin_s:.3f} s ({chunks(twin_phases)} chunks); "
        f"{len(told)} tells, {sum(bool(t.system_attrs.get(checkpoint.STRANDED_ATTR)) for t in resumed_trials)} "
        f"strays reaped, the twin's trials and values; K1 {sum(got_k1.values())} = {got_k1}; best "
        f"{twin.best_value:.6f}"
    )
    return {"k1": sum(got_k1.values()), "seed_s": seed_s, "restore_s": restore_s, "runs_s": (kill_s, resume_s, twin_s)}


# ------------------------------------------ phase 33: analysis and early stopping

ANALYSIS_HISTORY = 1100  # config #2's space at full width, past N_EXACT_MAX: the terminator's GP is SGPR (K1)
ANALYSIS_TREES = 64  # the forest evaluators' default n_trees
IMPORTANCE_TOL = 0.02  # fANOVA / MDI card against CPU (tests/test_importance_parity.py's band; the card's
#                        float32 sums run in another order, so trees part at near ties)
TERMINATOR_TOL = 1e-3  # RegretBound / EMMR card against CPU, in units of the score's sd: the posterior's
#                        1e-3 atol of tests/test_torch_gp_host.py (each side fits its own GP)
STAGNATION_K = 3  # TerminatorCallback(Terminator(BestValueStagnationEvaluator(k), StaticErrorEvaluator(0)))
STAGNATION_MAX_TRIALS = 60
DEFAULT_CALLBACK_TRIALS = 3  # GP trials from the 1100-trial history with the default TerminatorCallback()
HV_HISTORY_TRIALS, HV_HISTORY_M = 96, 5  # plot_hypervolume_history on 5-objective DTLZ2 (RandomSampler)
TERMINATOR_PLOT_TRIALS = 30


def analysis_study():
    """A RandomSampler study holding :func:`history_trials` (1100 Hartmann-20D trials)."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.samplers import RandomSampler

    study = ot.create_study(sampler=RandomSampler(seed=0))
    study.add_trials(history_trials(ANALYSIS_HISTORY))
    return study


def analysis_importance(study) -> dict:
    """fANOVA, MDI and PED-ANOVA on the card and with ``device="cpu"``; the
    forest's kernels and host syncs (profiler) and fANOVA's host part."""
    from optuna_tpu_torch import importance
    from optuna_tpu_torch.importance._fanova import _tree_group_variances
    from optuna_tpu_torch.ops.forest import fit_forest

    out = {}
    for name, cls in (("fANOVA", importance.FanovaImportanceEvaluator),
                      ("MDI", importance.MeanDecreaseImpurityImportanceEvaluator),
                      ("PED-ANOVA", importance.PedAnovaImportanceEvaluator)):
        kwargs = {} if cls is importance.PedAnovaImportanceEvaluator else {"n_trees": ANALYSIS_TREES, "seed": 0}
        card, card_s = timed(lambda: importance.get_param_importances(study, evaluator=cls(**kwargs)))
        card2, card2_s = timed(lambda: importance.get_param_importances(study, evaluator=cls(**kwargs)))
        cpu, cpu_s = timed(lambda: importance.get_param_importances(study, evaluator=cls(device="cpu", **kwargs)))
        if set(card) != set(cpu) or not all(math.isfinite(v) for v in card.values()):
            fail(f"importance {name}: card {card} against CPU {cpu}")
        gap = max(abs(card[k] - cpu[k]) for k in card)
        top = (max(card, key=card.get), max(cpu, key=cpu.get))
        if name == "PED-ANOVA":
            if card != cpu or card2 != card:
                fail(f"importance PED-ANOVA: the card's {card} is not the CPU's {cpu}")
        elif gap > IMPORTANCE_TOL or top[0] != top[1]:
            fail(f"importance {name}: card against CPU {gap:.3g} apart (tolerance {IMPORTANCE_TOL}), top {top}")
        out[name] = {"card_s": (card_s, card2_s), "cpu_s": cpu_s, "gap": gap, "top": top[0]}
        print(f"phase 33 importance {name} ({ANALYSIS_HISTORY} trials, 20 params): card {card_s * 1e3:.1f} / "
              f"{card2_s * 1e3:.1f} ms (first / second call), CPU {cpu_s * 1e3:.1f} ms; card against CPU max "
              f"|gap| {gap:.3g}, top {top[0]} ({card[top[0]]:.4f})")

    # The forest alone, as fANOVA grows it (encoded X in [0, 1]^20): traced, and its host variance part.
    from optuna_tpu_torch.transform import SearchSpaceTransform

    trials = study.get_trials(deepcopy=False)
    space = trials[0].distributions
    trans = SearchSpaceTransform(space, transform_log=False, transform_step=False, transform_0_1=True)
    X = trans.encode_many([t.params for t in trials])
    y = np.asarray([t.value for t in trials])
    trees, forest_s = timed(lambda: fit_forest(X, y, n_trees=ANALYSIS_TREES, seed=0))
    wall_ms, busy_ms, kernels, dtoh, syncs = profiled(
        "forest", lambda: fit_forest(X, y, n_trees=ANALYSIS_TREES, seed=0)
    )
    groups = [np.asarray(c) for c in trans.column_to_encoded_columns]
    t0 = time.perf_counter()
    for tree in trees:
        _tree_group_variances(tree, groups)
    host_ms = (time.perf_counter() - t0) * 1e3
    _, cpu_forest_s = timed(lambda: fit_forest(X, y, n_trees=ANALYSIS_TREES, seed=0, device="cpu"))
    print(f"phase 33 forest ({ANALYSIS_TREES} trees, {ANALYSIS_HISTORY} x 20, depth 10, 128 bins, chunks of 8): "
          f"card {forest_s * 1e3:.1f} ms ({kernels} kernels, {dtoh} device-to-host copies, {syncs} stream syncs "
          f"traced; {kernels / ANALYSIS_TREES * 8:.0f} kernels a chunk), CPU {cpu_forest_s * 1e3:.1f} ms; fANOVA's "
          f"host variance over the trees {host_ms:.1f} ms")
    out["forest"] = {"card_ms": forest_s * 1e3, "cpu_ms": cpu_forest_s * 1e3, "kernels": kernels, "dtoh": dtoh,
                     "syncs": syncs, "busy_ms": busy_ms, "wall_ms": wall_ms, "host_variance_ms": host_ms}
    return out


def analysis_terminator(study, k1_count, twins: CpuTwins) -> dict:
    """RegretBound and EMMR at n = 1100 on the card (K1 once a sparse fit) and
    on the CPU (:func:`cpu_terminator`, in the helper process)."""
    from optuna_tpu_torch.terminator import EMMREvaluator, RegretBoundEvaluator

    trials = study.get_trials(deepcopy=False)
    values = np.asarray([t.value for t in trials])
    sd = float(np.std(values))
    out = {"k1": 0}
    for cls, fits in ((RegretBoundEvaluator, 1), (EMMREvaluator, 2)):
        before = k1_count()
        card, card_s = timed(lambda: cls().evaluate(trials, study.direction))
        k1 = k1_count() - before
        cpu, cpu_s = twins.get("terminator")[cls.__name__]
        if k1 != fits:
            fail(f"terminator {cls.__name__}: K1 launched {k1} times, expected {fits} (one a sparse fit)")
        if not (math.isfinite(card) and math.isfinite(cpu)) or abs(card - cpu) > TERMINATOR_TOL * sd:
            fail(f"terminator {cls.__name__}: card {card} against CPU {cpu} (tolerance {TERMINATOR_TOL} x sd {sd:.4f})")
        out["k1"] += k1
        out[cls.__name__] = {"card_s": card_s, "cpu_s": cpu_s, "card": card, "cpu": cpu}
        print(f"phase 33 terminator {cls.__name__} at n={len(trials)} (SGPR, m 256): card {card_s:.3f} s, CPU "
              f"{cpu_s:.3f} s; value card {card:.6g}, CPU {cpu:.6g} (|gap| {abs(card - cpu):.3g}, sd {sd:.4f}); "
              f"K1 {k1}")
    return out


def stagnation_stop(values: list[float], k: int, min_n_trials: int = 20) -> int:
    """The trial count at which Terminator(BestValueStagnationEvaluator(k),
    StaticErrorEvaluator(0)) stops a minimizing study: the first prefix of at
    least ``min_n_trials`` whose best is more than ``k`` trials old."""
    for n in range(min_n_trials, len(values) + 1):
        best = int(np.argmin(values[:n]))  # the first best, as the evaluator keeps it
        if n - 1 - best > k:
            return n
    return len(values)


def analysis_callbacks(k1_count) -> dict:
    """The terminator in GP studies: the stagnation rule's stop, then the
    default TerminatorCallback() from the 1100-trial history."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.models.benchmarks import hartmann20
    from optuna_tpu_torch.samplers import GPSampler
    from optuna_tpu_torch.terminator import (
        BestValueStagnationEvaluator,
        StaticErrorEvaluator,
        Terminator,
        TerminatorCallback,
    )

    study = ot.create_study(sampler=GPSampler(seed=0))
    callback = TerminatorCallback(Terminator(BestValueStagnationEvaluator(STAGNATION_K), StaticErrorEvaluator(0.0)))
    _, stag_s = timed(lambda: study.optimize(hartmann20, n_trials=STAGNATION_MAX_TRIALS, callbacks=[callback]))
    values = [t.value for t in study.get_trials(deepcopy=False)]
    want = stagnation_stop(values, STAGNATION_K)
    if len(values) != want or len(values) >= STAGNATION_MAX_TRIALS:
        fail(f"terminator: the stagnation callback stopped at {len(values)} trials, the rule says {want}")

    study = seeded_study(ANALYSIS_HISTORY)
    default = TerminatorCallback()
    spent, k1_in_callback = [], [0]

    def timed_callback(study, trial):
        before = k1_count()
        t0 = time.perf_counter()
        default(study, trial)
        spent.append(time.perf_counter() - t0)
        k1_in_callback[0] += k1_count() - before

    before = k1_count()
    _, run_s = timed(lambda: study.optimize(hartmann20, n_trials=DEFAULT_CALLBACK_TRIALS, callbacks=[timed_callback]))
    k1 = k1_count() - before
    n_new = len(study.get_trials(deepcopy=False)) - ANALYSIS_HISTORY
    stopped = n_new < DEFAULT_CALLBACK_TRIALS
    check_gp_trials("terminator", study, ANALYSIS_HISTORY, n_new)
    if k1_in_callback[0] != n_new or k1 != 2 * n_new:
        fail(f"terminator: K1 {k1} over {n_new} sparse GP asks and callbacks ({k1_in_callback[0]} in the callbacks), "
             "expected one an ask and one a callback's regret bound")
    print(f"phase 33 terminator in a study: GPSampler on Hartmann-20D with TerminatorCallback(Terminator("
          f"BestValueStagnationEvaluator({STAGNATION_K}), StaticErrorEvaluator(0))) stopped at trial {len(values)} "
          f"as the rule says ({stag_s:.2f} s); the default TerminatorCallback() from {ANALYSIS_HISTORY} trials: "
          f"{n_new} GP trials in {run_s:.3f} s, the callback {[round(s, 4) for s in spent]} s a trial "
          f"({'stopped the study' if stopped else 'did not stop'}), K1 {k1} ({k1_in_callback[0]} in the callback)")
    return {"k1": k1, "callback_s": spent, "stagnation_stop": len(values)}


def hv_increments(values: np.ndarray, ref: np.ndarray) -> list[float]:
    """Every prefix's hypervolume in host float64, built up by exclusive
    contributions (vol(p) - HV of the prefix limited by p): independent of
    the routed path it is held against."""
    from optuna_tpu_torch.hypervolume.wfg import _pareto_filter
    from optuna_tpu_torch.hypervolume.wfg import compute_hypervolume as host_hv

    total, out = 0.0, []
    for i, p in enumerate(values):
        if np.all(p < ref):
            prev = values[:i][np.all(values[:i] < ref, axis=1)]
            limited = _pareto_filter(np.maximum(prev, p)) if len(prev) else prev
            total += float(np.prod(ref - p)) - (host_hv(limited, ref) if len(limited) else 0.0)
        out.append(total)
    return out


def analysis_hypervolume(stack) -> dict:
    """plot_hypervolume_history on 5-objective DTLZ2: K3 once a routed prefix."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.hypervolume.wfg import _pareto_filter
    from optuna_tpu_torch.samplers import RandomSampler
    from optuna_tpu_torch.visualization import plot_hypervolume_history

    study = ot.create_study(directions=["minimize"] * HV_HISTORY_M, sampler=RandomSampler(seed=0))
    study.optimize(lambda t: dtlz2(t, m=HV_HISTORY_M), n_trials=HV_HISTORY_TRIALS)
    values = np.asarray([t.values for t in study.get_trials(deepcopy=False)])
    ref = values.max(axis=0) * 1.1
    # The routing rule of hypervolume.compute_hypervolume: every point lies inside ref, so a prefix takes
    # the WFG stack once its Pareto front holds 32 points (the front can shrink as well as grow).
    fronts = [len(_pareto_filter(values[: i + 1])) for i in range(len(values))]
    routed = sum(f >= 32 for f in fronts)
    before = stack.STACK_LAUNCHES
    fig, seconds = timed(lambda: plot_hypervolume_history(study, list(ref)))
    launches = stack.STACK_LAUNCHES - before
    hv = np.asarray(fig["data"][0]["y"])
    want = np.asarray(hv_increments(values, ref))
    rel = float(np.max(np.abs(hv - want) / np.maximum(want, 1e-300)))
    if launches != routed or routed < 1:
        fail(f"hypervolume history: K3 launched {launches} times, expected {routed} (one a prefix whose front holds "
             "32 points or more)")
    if rel > HV_TOL_F64 or len(hv) != HV_HISTORY_TRIALS:
        fail(f"hypervolume history: {len(hv)} values, {rel:.3g} from host float64 (tolerance {HV_TOL_F64})")
    json.dumps(fig)
    print(f"phase 33 plot_hypervolume_history ({HV_HISTORY_M}-objective DTLZ2, {HV_HISTORY_TRIALS} RandomSampler "
          f"trials): {seconds:.3f} s, K3 {launches} (one a prefix whose front holds 32 points or more, the first "
          f"at trial {next(i for i, f in enumerate(fronts) if f >= 32)}; final front {fronts[-1]}), max rel gap to "
          f"host float64 {rel:.3g}, final {hv[-1]:.6f}")
    return {"k3": launches, "s": seconds}


def analysis_figures(study) -> float:
    """plot_param_importances, plot_optimization_history and
    plot_terminator_improvement as JSON-serializable figure dicts."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch import visualization as vis
    from optuna_tpu_torch.samplers import RandomSampler

    t0 = time.perf_counter()
    small = ot.create_study(sampler=RandomSampler(seed=0))
    small.add_trials(history_trials(TERMINATOR_PLOT_TRIALS, seed=1))
    figs = {
        "plot_param_importances": vis.plot_param_importances(study),
        "plot_optimization_history": vis.plot_optimization_history(study),
        "plot_terminator_improvement": vis.plot_terminator_improvement(small),
    }
    for name, fig in figs.items():
        if not isinstance(fig, dict) or not fig.get("data"):
            fail(f"figures: {name} returned {type(fig).__name__}")
        json.dumps(fig)
    improvement = figs["plot_terminator_improvement"]["data"][0]["y"]
    if len(improvement) != TERMINATOR_PLOT_TRIALS - 20 + 1 or not all(math.isfinite(v) for v in improvement):
        fail(f"figures: terminator improvement {improvement}")
    seconds = time.perf_counter() - t0
    print(f"phase 33 figures: plot_param_importances, plot_optimization_history, plot_terminator_improvement "
          f"({TERMINATOR_PLOT_TRIALS} trials, {len(improvement)} exact GP fits) as JSON dicts in {seconds:.2f} s")
    return seconds


def analysis_cli() -> float:
    """One `python -m optuna_tpu_torch.cli` ask/tell round over sqlite, the
    ask past TPE's 10 startup trials (its KDE on the card)."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch.distributions import FloatDistribution

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        url = f"sqlite:///{os.path.join(tmp, 'cli.db')}"
        rng = np.random.default_rng(3)
        study = ot.create_study(storage=url, study_name="cli")
        dists = {"x": FloatDistribution(0.0, 1.0), "y": FloatDistribution(0.0, 1.0)}
        study.add_trials([
            ot.create_trial(params={"x": float(a), "y": float(b)}, distributions=dists, value=float((a - 0.3) ** 2 + b))
            for a, b in rng.uniform(0, 1, (12, 2))
        ])
        space = json.dumps({n: {"name": "FloatDistribution", "attributes": {"low": 0.0, "high": 1.0, "log": False,
                                                                              "step": None}} for n in dists})
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))

        def cli(*argv):
            proc = subprocess.run([sys.executable, "-m", "optuna_tpu_torch.cli", *argv], capture_output=True,
                                  text=True, env=env, timeout=300)
            if proc.returncode != 0:
                fail(f"cli {argv[0]}: exit {proc.returncode}: {proc.stderr.strip()[-800:]}")
            return proc.stdout

        t0 = time.perf_counter()
        asked = json.loads(cli("ask", "--storage", url, "--study-name", "cli", "--search-space", space,
                               "--sampler", "TPESampler", "--sampler-kwargs", json.dumps({"seed": 0, "device": "cuda"})))
        ask_s = time.perf_counter() - t0
        value = (asked["params"]["x"] - 0.3) ** 2 + asked["params"]["y"]
        t0 = time.perf_counter()
        cli("tell", "--storage", url, "--study-name", "cli", "--trial-number", str(asked["number"]), "--values",
            repr(value))
        tell_s = time.perf_counter() - t0
        rows = ot.load_study(study_name="cli", storage=url).get_trials(deepcopy=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    last = rows[-1]
    if len(rows) != 13 or last.number != 12 or last.state != ot.TrialState.COMPLETE or last.values != [value]:
        fail(f"cli: the round left {len(rows)} trials, the last {last}")
    if not all(0.0 <= asked["params"][n] <= 1.0 for n in ("x", "y")):
        fail(f"cli: asked {asked}")
    print(f"phase 33 CLI: `python -m optuna_tpu_torch.cli ask` (TPESampler on cuda, trial 12 past 10 startup) "
          f"{ask_s:.2f} s, `tell` {tell_s:.2f} s (a process each, imports included), trial 12 COMPLETE at "
          f"{value:.6f}")
    return ask_s + tell_s


def phase_analysis(k1_count, stack, twins: CpuTwins) -> dict:
    """Phase 33 (see the module docstring)."""
    study = analysis_study()
    importance = analysis_importance(study)
    terminator = analysis_terminator(study, k1_count, twins)
    callbacks = analysis_callbacks(k1_count)
    hv = analysis_hypervolume(stack)
    figures_s = analysis_figures(study)
    cli_s = analysis_cli()
    return {"importance": importance, "terminator": terminator, "callbacks": callbacks, "hv": hv,
            "k1": terminator["k1"] + callbacks["k1"], "k3": hv["k3"], "figures_s": figures_s, "cli_s": cli_s}


# ---------------------------- phase 34: the doctor and the autopilot on config #2's scan

AUTOPILOT_HISTORY = 1100  # config #2's space at full width, bucket 2048: every chunk of 32 is SGPR
AUTOPILOT_SYNC = 32
AUTOPILOT_M = 128  # n_inducing; gp.densify doubles it to N_INDUCING_MAX (256)
# Chunk k+1 is dispatched before chunk k syncs, so a decision at chunk 0's sync
# shapes chunk 2, and a verdict rollback_after tells later (chunk 2's sync)
# shapes chunk 4: five chunks, and a verdict that reads chunk 2's error at m = 256.
AUTOPILOT_TRIALS = 5 * AUTOPILOT_SYNC
AUTOPILOT_ROLLBACK_AFTER = 2 * AUTOPILOT_SYNC
AUTOPILOT_TWIN_TRIALS = AUTOPILOT_SYNC  # one SGPR chunk a twin; the hooks' cost is timed in turns
K1_SYMBOL = "matern52_gram_kernel"
AUTOPILOT_WORKER = "chip-smoke-34"


class ChunkK1Spy:
    """K1's launches on the scan path by chunk: wraps the scan loop's
    ``_chunk_draws`` (called once a chunk with its index, before the chunk
    program) and ``gp.sparse.matern52_gram`` (K1's wrapper, which
    ``sgpr_reduce`` calls), recording ``(chunk, inducing rows)`` for every
    call on CUDA tensors. ``on_chunk(k)`` runs as chunk k starts."""

    def __init__(self, on_chunk=None) -> None:
        self.on_chunk = on_chunk
        self.chunk = -1
        self.calls: list[tuple[int, int]] = []

    def __enter__(self) -> "ChunkK1Spy":
        from optuna_tpu_torch.gp import sparse
        from optuna_tpu_torch.parallel import scan_loop

        self._draws, self._gram = scan_loop._chunk_draws, sparse.matern52_gram

        def draws(key_seed, chunk_idx, *args, **kwargs):
            self.chunk = chunk_idx
            if self.on_chunk is not None:
                self.on_chunk(chunk_idx)
            return self._draws(key_seed, chunk_idx, *args, **kwargs)

        def gram(x1, *args, **kwargs):
            if x1.is_cuda:
                self.calls.append((self.chunk, int(x1.shape[0])))
            return self._gram(x1, *args, **kwargs)

        scan_loop._chunk_draws, sparse.matern52_gram = draws, gram
        return self

    def __exit__(self, *exc) -> None:
        from optuna_tpu_torch.gp import sparse
        from optuna_tpu_torch.parallel import scan_loop

        scan_loop._chunk_draws, sparse.matern52_gram = self._draws, self._gram

    def rows(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for chunk, rows in self.calls:
            out.setdefault(chunk, []).append(rows)
        return out


_PROM_LINE = r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>[^}]*)\})? (?P<value>\S+)$"
_PROM_LABEL = r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'


def parse_exposition(text: str) -> int:
    """Sample lines of a Prometheus exposition, each held to the grammar of
    the reference's ``tests/test_telemetry.py::_parse_exposition``."""
    import re

    line_re, label_re = re.compile(_PROM_LINE), re.compile(_PROM_LABEL)
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        if m is None or (m.group("labels") and label_re.sub("", m.group("labels")).strip(", ")):
            fail(f"phase 34: an exposition line breaks the grammar: {line!r}")
        float(m.group("value"))
        n += 1
    return n


def k1_in_chunk_range(trace: dict) -> tuple[int, int]:
    """(K1 kernels in a profiler trace, those inside a ``scan.chunk`` range):
    the kernel's launch (the runtime event of its correlation id) or, where
    the trace has none, the kernel itself inside the range's span."""
    events = trace.get("traceEvents", [])
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("ph") == "X" and e.get("name") == "optuna_tpu_torch.scan.chunk"]
    kernels = [e for e in events if e.get("ph") == "X" and K1_SYMBOL in str(e.get("name", ""))
               and e.get("cat") == "kernel"]
    launches = {e.get("args", {}).get("correlation"): e for e in events
                if e.get("cat") == "cuda_runtime" and e.get("args", {}).get("correlation") is not None}
    inside = 0
    for k in kernels:
        at = launches.get(k.get("args", {}).get("correlation"), k)["ts"]
        inside += any(lo <= at <= hi for lo, hi in ranges)
    return len(kernels), inside


def autopilot_policy(mode: str):
    from optuna_tpu_torch.autopilot import AutopilotPolicy

    return AutopilotPolicy(mode=mode, interval_s=0.0, overrides={"sparse_heldout_err_warn": 0.0},
                           rollback_after=AUTOPILOT_ROLLBACK_AFTER, cooldown_s=3600.0)


def hooks(on: bool) -> None:
    """Telemetry, the flight recorder and the health reporter (at every sync)
    all on, with fresh state, or all off."""
    from optuna_tpu_torch import flight, health, telemetry

    if on:
        telemetry.enable(telemetry.MetricsRegistry())
        flight.enable(flight.FlightRecorder(capacity=65536))
        health.enable(interval_s=0.0, worker_id=AUTOPILOT_WORKER)
    else:
        health.disable()
        flight.disable()
        telemetry.disable()


def autopilot_cli(url: str) -> tuple[dict, dict, float]:
    """``optuna-tpu-torch doctor`` and ``autopilot`` over the sqlite file, each
    in a process of its own (the two side by side), as a shell user runs them."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    procs = {
        command: subprocess.Popen([sys.executable, "-m", "optuna_tpu_torch.cli", command, "--storage", url,
                                   "--study-name", "autopilot", "--format", "json"],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for command in ("doctor", "autopilot")
    }
    out = {}
    for command, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.communicate()
            fail(f"phase 34: cli {command} timed out")
        if proc.returncode != 0:
            fail(f"phase 34: cli {command}: exit {proc.returncode}: {stderr.strip()[-800:]}")
        out[command] = json.loads(stdout)
    return out["doctor"], out["autopilot"], time.perf_counter() - t0


def autopilot_exports(study) -> dict:
    """The act run's exports: the Chrome trace (chunk and sync spans, the
    action events, the card's memory gauge), the Prometheus text (held to
    the exposition grammar) and ``serve_metrics`` on a loopback port."""
    import urllib.request

    from optuna_tpu_torch import health, telemetry

    trace = study.trace_snapshot()
    spans = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    actions = {e["name"] for e in trace["traceEvents"] if e["name"].startswith("autopilot.action.")}
    gauges = [e for e in trace["traceEvents"] if e.get("ph") == "C" and e["name"] == "hbm.peak_bytes"]
    if not {"scan.chunk", "scan.sync"} <= spans or "autopilot.action.gp.densify" not in actions or not gauges:
        fail(f"phase 34: the trace holds spans {sorted(spans)}, actions {sorted(actions)}, {len(gauges)} "
             "hbm.peak_bytes gauges")
    text = telemetry.render_prometheus()
    samples = parse_exposition(text)
    if "optuna_tpu_autopilot_action_gp_densify_total 1" not in text:
        fail("phase 34: the exposition lacks the gp.densify counter")
    server = telemetry.serve_metrics(0, host="127.0.0.1",
                                     health_source=lambda: health.storage_health_reports(study._storage))
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            served = r.read().decode()
        with urllib.request.urlopen(base + "/health.json", timeout=60) as r:
            reports = json.loads(r.read().decode())["reports"]
    finally:
        server.shutdown()
        server.server_close()
    if parse_exposition(served) < samples or [r["study"] for r in reports] != ["autopilot"]:
        fail(f"phase 34: /metrics served {parse_exposition(served)} samples, /health.json studies "
             f"{[r['study'] for r in reports]}")
    return {"trace_events": len(trace["traceEvents"]), "samples": samples,
            "hbm_peak_bytes": gauges[-1]["args"]["value"], "health_findings": [f["check"] for f in reports[0]["findings"]]}


def autopilot_batched() -> dict:
    """``AutopilotChaosPlan`` through ``optimize_vectorized(autopilot=...)`` on
    the card: its NaN proposals under GuardedSampler, its NaN batch slots,
    its constant seeded history, 24 trials in batches of 8."""
    import optuna_tpu_torch as ot
    from optuna_tpu_torch import flight, telemetry
    from optuna_tpu_torch.autopilot import AutopilotPolicy
    from optuna_tpu_torch.distributions import FloatDistribution
    from optuna_tpu_torch.parallel import optimize_vectorized
    from optuna_tpu_torch.samplers import RandomSampler
    from optuna_tpu_torch.samplers._resilience import GuardedSampler
    from optuna_tpu_torch.testing import fault_injection as fi

    plan = fi.autopilot_chaos_plan()
    space = {"x": FloatDistribution(0.0, 1.0)}
    telemetry.enable(telemetry.MetricsRegistry())
    flight.enable(flight.FlightRecorder())
    try:
        sampler = GuardedSampler(fi.FaultySampler(RandomSampler(seed=0), nan_at=set(plan.sampler_nan_at),
                                                  force_relative=True))
        study = ot.create_study(sampler=sampler)
        fi.PATHOLOGICAL_HISTORY_PLANS[plan.seeded_history_plan].populate(study, space, seed=0)
        obj = fi.FaultyVectorizedObjective(lambda p: (p["x"] - 0.3) ** 2 + 1.0, space, nan_at=dict(plan.nan_slots))
        t0 = time.perf_counter()
        optimize_vectorized(study, obj, n_trials=plan.n_trials, batch_size=plan.batch_size,
                            autopilot=AutopilotPolicy(mode="act", interval_s=0.0, cooldown_s=plan.cooldown_s,
                                                      budget=plan.budget, rollback_after=plan.rollback_after,
                                                      pin_trials=plan.pin_trials,
                                                      overrides={"stagnation_window": plan.stagnation_window}))
        seconds = time.perf_counter() - t0
    finally:
        telemetry.disable()
        flight.disable()
    records = study.__dict__["_autopilot"].report()["actions"]
    states = {r["action"]: r["state"] for r in records}
    running = sum(t.state == ot.TrialState.RUNNING for t in study.trials)
    if sorted(r["action"] for r in records) != sorted(plan.expected_actions) or \
            states[plan.rollback_action] != "rolled_back" or running:
        fail(f"phase 34: the batched chaos plan decided {states} with {running} RUNNING, expected each of "
             f"{plan.expected_actions} once and {plan.rollback_action} rolled back")
    if obj.dispatch_widths != [plan.batch_size] * (plan.n_trials // plan.batch_size):
        fail(f"phase 34: the batched plan dispatched widths {obj.dispatch_widths}")
    return {"states": states, "s": seconds}


def phase_autopilot(k1_count) -> dict:
    """Phase 34 (see the module docstring)."""
    import torch

    import optuna_tpu_torch as ot
    from optuna_tpu_torch import _device_policy, _tracing, autopilot, flight, telemetry
    from optuna_tpu_torch.parallel import optimize_scan
    from optuna_tpu_torch.samplers import RandomSampler

    t_phase = time.perf_counter()
    latency = _device_policy.default_dispatch_latency_s()
    routed = _device_policy.small_kernel_device()
    if routed.type != "cuda":
        fail(f"phase 34: the device policy routes small kernels to {routed} (round trip {latency * 1e3:.3f} ms)")
    print(f"phase 34 device policy: the card's round trip {latency * 1e3:.4f} ms (best of 3): small kernels on {routed}")

    objective = scan_objective()
    kwargs = dict(sync_every=AUTOPILOT_SYNC, seed=0, n_exact_max=1024, n_inducing=AUTOPILOT_M)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autopilot_")
    logdir = os.path.join(tmp, "trace")
    try:
        history = history_trials(AUTOPILOT_HISTORY)
        urls = {run: f"sqlite:///{os.path.join(tmp, run + '.db')}" for run in ("act", "observe", "off", "bare", "bare2")}
        t0 = time.perf_counter()
        for url in urls.values():
            ot.create_study(storage=url, study_name="autopilot", sampler=RandomSampler(seed=0)).add_trials(history)
        seed_s = (time.perf_counter() - t0) / len(urls)

        # ------------------------------------------------ the act run, traced at chunk 2
        tracing = {}

        def on_chunk(k):
            if k == 2:
                tracing["cm"] = _tracing.trace(logdir)
                tracing["cm"].__enter__()
            elif k == 3 and "cm" in tracing:
                tracing.pop("cm").__exit__(None, None, None)

        hooks(True)
        k1_before = k1_count()
        try:
            study = ot.Study("autopilot", urls["act"], sampler=RandomSampler(seed=0),
                             autopilot=autopilot_policy("act"))
            with ChunkK1Spy(on_chunk) as spy:
                t0 = time.perf_counter()
                optimize_scan(study, objective, AUTOPILOT_TRIALS, **kwargs)
                torch.cuda.synchronize()
                act_s = time.perf_counter() - t0
            if "cm" in tracing:
                tracing.pop("cm").__exit__(None, None, None)
            k1_act = k1_count() - k1_before
            phases = telemetry.phase_totals()
            # Each chunk's seconds from the flight recorder's scan.chunk spans, in order.
            chunk_s = [ev.dur for ev in flight.events() if ev.kind == "phase" and ev.name == "scan.chunk"]
            exports = autopilot_exports(study)
            postmortem = flight.last_postmortem_path()
        finally:
            hooks(False)
        records = study.__dict__["_autopilot"].report()["actions"]
        densify = [r for r in records if r["action"] == "gp.densify"]
        if len(densify) != 1 or densify[0]["state"] not in ("held", "rolled_back"):
            fail(f"phase 34: the act run's gp.densify records are {densify} (all: {records})")
        decision = densify[0]
        verdict = decision["state"]
        m_after = 2 * AUTOPILOT_M if verdict == "held" else AUTOPILOT_M
        want_rows = {0: [AUTOPILOT_M], 1: [AUTOPILOT_M], 2: [2 * AUTOPILOT_M], 3: [2 * AUTOPILOT_M], 4: [m_after]}
        rows = {k: sorted(set(v)) for k, v in spy.rows().items()}
        if rows != want_rows or len(spy.calls) != k1_act:
            fail(f"phase 34: K1's inducing rows by chunk {rows}, expected {want_rows}; {len(spy.calls)} calls "
                 f"and {k1_act} launches")
        if study._scan_gp_control["n_inducing"] != m_after or postmortem is not None:
            fail(f"phase 34: the control dict {study._scan_gp_control} after a {verdict} verdict "
                 f"(postmortem {postmortem})")
        n_k1, k1_inside = k1_in_chunk_range(json.loads(open(_tracing.last_trace_path).read()))
        if n_k1 < 1 or k1_inside != n_k1:
            fail(f"phase 34: the profiler trace of chunk 2 holds {n_k1} K1 kernels, {k1_inside} inside scan.chunk")
        mirror = {k: v for k, v in ot.load_study(study_name="autopilot", storage=urls["act"]).system_attrs.items()
                  if k.startswith(autopilot.ACTION_ATTR_PREFIX)}
        if not any(v["action"] == "gp.densify" and v["state"] == verdict for v in mirror.values()):
            fail(f"phase 34: the sqlite mirror holds {mirror}")
        doctor, audit, cli_s = autopilot_cli(urls["act"])
        err = doctor["fleet"]["gauges"].get("device.gp.sparse_heldout_err.last")
        listed = "gp.sparse_degraded" in {f["check"] for f in doctor["findings"]}
        if err is None or listed != (err >= 1.0):
            fail(f"phase 34: the doctor's fleet gauge is {err} and it lists gp.sparse_degraded: {listed} (the "
                 "CLI's threshold is the default, 1.0)")
        (loop,) = audit["autopilots"]
        if [(r["action"], r["state"]) for r in loop["actions"] if r["action"] == "gp.densify"] != [
                ("gp.densify", verdict)]:
            fail(f"phase 34: `optuna-tpu-torch autopilot` lists {loop['actions']}")

        # --------------------- twins, in turns: all hooks off, observe, autopilot off, all hooks off
        twins, twin_s, twin_k1, observe_records = {}, {}, {}, []
        for run in ("bare", "observe", "off", "bare2"):
            hooks(not run.startswith("bare"))
            k1_before = k1_count()
            try:
                twin = ot.Study("autopilot", urls[run], sampler=RandomSampler(seed=0),
                                autopilot=autopilot_policy("observe") if run == "observe" else None)
                t0 = time.perf_counter()
                optimize_scan(twin, objective, AUTOPILOT_TWIN_TRIALS, **kwargs)
                torch.cuda.synchronize()
                twin_s[run] = time.perf_counter() - t0
            finally:
                hooks(False)
            twin_k1[run] = k1_count() - k1_before
            twins[run] = [(t.params, t.values) for t in twin.get_trials(deepcopy=False)[AUTOPILOT_HISTORY:]]
            if run == "observe":
                observe_records = twin.__dict__["_autopilot"].report()["actions"]
        if not (twins["bare"] == twins["observe"] == twins["off"] == twins["bare2"]) or \
                len(twins["bare"]) != AUTOPILOT_TWIN_TRIALS:
            fail("phase 34: the observe, autopilot-off and all-hooks-off twins part")
        first = [(r["action"], r["check"], r["evidence"], r["state"]) for r in observe_records
                 if r["action"] == "gp.densify"]
        # Observe records decide and execute nothing (no_target: a finding whose knob this loop lacks).
        if first != [(decision["action"], decision["check"], decision["evidence"], "observed")] or \
                not {r["state"] for r in observe_records} <= {"observed", "no_target"}:
            fail(f"phase 34: the observe twin decided {observe_records}, the act run first {decision}")
        if any(k.startswith(autopilot.ACTION_ATTR_PREFIX) for k in
               ot.load_study(study_name="autopilot", storage=urls["observe"]).system_attrs):
            fail("phase 34: the observe twin mirrored a decision into storage")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    batched = autopilot_batched()

    chunk = phases.get("scan.chunk", {})
    per_chunk = {"on": (twin_s["observe"] + twin_s["off"]) / 2, "off": (twin_s["bare"] + twin_s["bare2"]) / 2}
    k1 = k1_act + sum(twin_k1.values())
    seconds = time.perf_counter() - t_phase
    print(
        f"phase 34, the doctor and the autopilot on config #2's scan (Hartmann-20D, {AUTOPILOT_HISTORY} seeded on "
        f"sqlite in {seed_s:.3f} s, chunks of {AUTOPILOT_SYNC}, n_exact_max {kwargs['n_exact_max']}, m {AUTOPILOT_M}): act run "
        f"{AUTOPILOT_TRIALS} trials in {act_s:.3f} s ({int(chunk.get('count', 0))} chunks, scan.chunk "
        f"{chunk.get('total_s', 0.0):.4f} s, scan.sync {phases.get('scan.sync', {}).get('total_s', 0.0):.4f} s, chunk "
        f"2 profiled; s a chunk by the flight recorder {[round(x, 4) for x in chunk_s]}); gp.densify decided at chunk 0's sync on held-out error {decision['evidence']['heldout_err']:.6f}"
        f", {verdict} at chunk 2's sync (rollback_after {AUTOPILOT_ROLLBACK_AFTER}); K1's inducing rows by chunk "
        f"{rows}; the profiler trace holds {n_k1} K1 kernel(s) ({K1_SYMBOL}), all inside scan.chunk; mirror "
        f"{sorted((v['action'], v['state']) for v in mirror.values())}; CLI doctor and autopilot {cli_s:.2f} s (two "
        f"processes), doctor findings {sorted(f['check'] for f in doctor['findings'])} at fleet held-out error "
        f"{err:.6f}; exports: {exports['trace_events']} trace events, {exports['samples']} exposition samples, "
        f"hbm.peak_bytes {exports['hbm_peak_bytes']:.0f}; twins of one SGPR chunk ({AUTOPILOT_TWIN_TRIALS} trials) "
        f"identical, in turns: all hooks off {twin_s['bare']:.4f} s, observe {twin_s['observe']:.4f} s, autopilot "
        f"off {twin_s['off']:.4f} s, all hooks off {twin_s['bare2']:.4f} s: an SGPR chunk with every hook on "
        f"{per_chunk['on']:.4f} s, every hook off {per_chunk['off']:.4f} s, the hooks "
        f"{per_chunk['on'] - per_chunk['off']:.4f} s a chunk; batched chaos plan on the card "
        f"{batched['states']} in {batched['s']:.3f} s; K1 {k1} (act {k1_act}, twins {twin_k1}); phase "
        f"{seconds:.1f} s"
    )
    return {"k1": k1, "verdict": verdict, "s": seconds, "per_chunk": per_chunk, "act_s": act_s, "chunk_s": chunk_s}


SERVE_HISTORY = 1100  # config #2's history past N_EXACT_MAX = 1024: every hub dispatch is SGPR (m = 256, K1)
SERVE_TWIN_TRIALS = 3
SERVE_CLIENTS, SERVE_ASKS = 8, 2
SERVE_WINDOW_S = 0.05  # long enough for the eight client threads to meet in one window
SERVE_FLEET_TRIALS, SERVE_AFTER_KILL = 8, 2  # 4 after the kill before the script's total neared its limit
SERVE_CKPT_EVERY = 4


def serve_stack(storage, factory, **kwargs):
    """A ``SuggestService`` over ``storage`` behind the server's grpc-free
    request dispatcher (``testing.fault_injection.mount_dispatch``: wire
    codec, op tokens, dispatch; ``bench.py --loop=serve --transport=handler``).
    Returns (service, mounted storage, ask callable for ``ThinClientSampler``
    that records each RPC's seconds)."""
    from optuna_tpu_torch.storages._grpc.suggest_service import SuggestService
    from optuna_tpu_torch.testing.fault_injection import mount_dispatch, thin_client_ask

    kwargs.setdefault("health_reporting", False)
    service = SuggestService(storage, factory, **kwargs)
    mounted, rpc = mount_dispatch(storage, service)
    served = thin_client_ask(rpc)
    ask_s: list[float] = []

    def ask(study_id, trial_id, number, token):
        t0 = time.perf_counter()
        try:
            return served(study_id, trial_id, number, token)
        finally:
            ask_s.append(time.perf_counter() - t0)

    ask.seconds = ask_s
    return service, mounted, ask


def check_served(label: str, study, first: int, n_new: int, samplers=()) -> None:
    """``check_gp_trials``, and nothing degraded on the way: no
    ``sampler_fallback:`` attr on a trial or the study, and every ask of
    every thin client answered by the service (no shed, no local
    independent sampling)."""
    check_gp_trials(label, study, first, n_new)
    new = study.get_trials(deepcopy=False)[first:]
    if not all(in_distributions(t) for t in new):
        fail(f"{label}: a served trial is outside its distributions")
    attrs = [k for t in new for k in t.system_attrs if k.startswith("sampler_fallback:")]
    attrs += [k for k in study.system_attrs if k.startswith("sampler_fallback:")]
    if attrs:
        fail(f"{label}: degraded asks: {attrs}")
    sources = [s for sampler in samplers for s in sampler.served_sources]
    if samplers and (len(sources) != n_new or not set(sources) <= {"coalesced", "ready_queue"}):
        fail(f"{label}: {len(sources)} served answers for {n_new} trials, sources {sorted(set(sources))}")


def phase_serve(k1_count) -> dict:
    """Phase 35 (see the module docstring)."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    import optuna_tpu_torch as ot
    from optuna_tpu_torch import telemetry
    from optuna_tpu_torch.models.benchmarks import hartmann20
    from optuna_tpu_torch.samplers import GPSampler, RandomSampler
    from optuna_tpu_torch.storages import InMemoryStorage, RDBStorage
    from optuna_tpu_torch.storages._grpc.fleet import read_lease
    from optuna_tpu_torch.storages._grpc.suggest_service import ShedPolicy, SuggestService, ThinClientSampler
    from optuna_tpu_torch.testing.fault_injection import FakeHubFleet

    t_phase = time.perf_counter()
    history = history_trials(SERVE_HISTORY)
    factory = lambda: GPSampler(seed=0)  # noqa: E731
    out: dict = {}

    # (a) Width-1 twin: a lone ask is the exact per-trial sample_relative.
    local = seeded_study(SERVE_HISTORY)
    before = k1_count()
    t0 = time.perf_counter()
    local.optimize(hartmann20, n_trials=SERVE_TWIN_TRIALS)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    k1_local = k1_count() - before
    service, mounted, ask = serve_stack(InMemoryStorage(), factory, ready_ahead=0, coalesce_window_s=0.0)
    ot.create_study(storage=mounted, study_name="twin", sampler=RandomSampler()).add_trials(history)
    sampler = ThinClientSampler(ask, seed=0)
    served = ot.load_study(study_name="twin", storage=mounted, sampler=sampler)
    before = k1_count()
    t0 = time.perf_counter()
    served.optimize(hartmann20, n_trials=SERVE_TWIN_TRIALS)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    k1_served = k1_count() - before
    service.close()
    check_served("phase 35(a)", served, SERVE_HISTORY, SERVE_TWIN_TRIALS, [sampler])
    want = [t.params for t in local.get_trials(deepcopy=False)[SERVE_HISTORY:]]
    got = [t.params for t in served.get_trials(deepcopy=False)[SERVE_HISTORY:]]
    if got != want:
        fail("phase 35(a): the width-1 thin client parts from the local GPSampler(seed=0) study")
    if k1_local != SERVE_TWIN_TRIALS or k1_served != SERVE_TWIN_TRIALS:
        fail(f"phase 35(a): K1 launched {k1_local} (local) and {k1_served} (served) times over "
             f"{SERVE_TWIN_TRIALS} asks each, expected once an ask")
    out["twin"] = {"local_ms": local_s / SERVE_TWIN_TRIALS * 1e3, "served_ms": served_s / SERVE_TWIN_TRIALS * 1e3,
                   "ask_ms": [round(s * 1e3, 3) for s in ask.seconds], "k1": k1_local + k1_served}

    # (b) Coalesced serving: eight client threads, two asks each.
    n = SERVE_CLIENTS
    telemetry.enable(telemetry.MetricsRegistry())
    try:
        service, mounted, ask = serve_stack(
            InMemoryStorage(), factory, max_coalesce=n, ready_ahead=n, invalidate_after=n,
            coalesce_window_s=SERVE_WINDOW_S,
            shed_policy=ShedPolicy(degrade_depth=2 * n, independent_depth=4 * n, reject_depth=8 * n,
                                   slo_source=lambda: ()),
        )
        ot.create_study(storage=mounted, study_name="coalesced", sampler=RandomSampler()).add_trials(history)
        clients = [ThinClientSampler(ask, seed=k) for k in range(n)]
        studies = [ot.load_study(study_name="coalesced", storage=mounted, sampler=c) for c in clients]
        errors: list = []

        def client(study):
            try:
                study.optimize(hartmann20, n_trials=1)
            except BaseException as err:  # noqa: BLE001 -- reported by the main thread below
                errors.append(err)

        def ask_round() -> float:
            """Every client asks (and tells) once, all at the same time."""
            threads = [threading.Thread(target=client, args=(s,), name=f"serve-client-{k}")
                       for k, s in enumerate(studies)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600.0)
            torch.cuda.synchronize()
            if errors or any(th.is_alive() for th in threads):
                fail(f"phase 35(b): client threads failed or hung: {errors!r}")
            return time.perf_counter() - t0

        before = k1_count()
        rounds_s = [ask_round() for _ in range(SERVE_ASKS)]
        wall_s = sum(rounds_s)
        snap, phases, n_timed = telemetry.snapshot(), telemetry.phase_totals(), len(ask.seconds)
        # The busy share: one more round, the ready queue emptied first so that
        # it misses and coalesces as the first did, under the profiler (apart,
        # so that the profiler's cost stays out of the timed rounds).
        service._handles[studies[0]._study_id].queue.refill([])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiled_s = ask_round()
        service.close()  # joins the refill worker, so its last dispatch is counted
        torch.cuda.synchronize()
        k1_b = k1_count() - before
        final, final_phases = telemetry.snapshot(), telemetry.phase_totals()
    finally:
        telemetry.disable()
    t0 = time.perf_counter()
    busy_ms, n_kernels = device_busy(prof)
    readback_s = time.perf_counter() - t0
    check_served("phase 35(b)", studies[0], SERVE_HISTORY, n * (SERVE_ASKS + 1), clients)
    counters, gauges = snap["counters"], snap["gauges"]
    dispatches = int(phases.get("serve.coalesce", {}).get("count", 0))
    refills = int(counters.get("serve.ready_queue.refill", 0))
    all_dispatches = int(final_phases.get("serve.coalesce", {}).get("count", 0))
    all_refills = int(final["counters"].get("serve.ready_queue.refill", 0))
    sheds = {k: v for k, v in final["counters"].items() if k.startswith("serve.shed.")}
    width_max = int(gauges.get("serve.coalesce.width.max", 0))
    if width_max < 2:
        fail(f"phase 35(b): the widest coalesced dispatch was {width_max}, expected >= 2")
    if sheds:
        fail(f"phase 35(b): asks were shed: {sheds}")
    if k1_b != all_dispatches + all_refills:
        fail(f"phase 35(b): K1 launched {k1_b} times over {all_dispatches} coalesced dispatches and "
             f"{all_refills} refills")
    ask_ms = np.array(ask.seconds[:n_timed]) * 1e3
    out["coalesced"] = {
        "wall_s": wall_s, "ms_per_trial": wall_s / (n * SERVE_ASKS) * 1e3, "dispatches": dispatches,
        "refills": refills, "width_max": width_max, "hits": int(counters.get("serve.ready_queue.hit", 0)),
        "misses": int(counters.get("serve.ready_queue.miss", 0)), "p50_ms": float(np.percentile(ask_ms, 50)),
        "p99_ms": float(np.percentile(ask_ms, 99)), "k1": k1_b, "busy_ms": busy_ms, "kernels": n_kernels,
        "busy_share": busy_ms / (profiled_s * 1e3), "profiled_s": profiled_s, "readback_s": readback_s,
        "round3": (all_dispatches - dispatches, all_refills - refills),
        "coalesce_s": phases.get("serve.coalesce", {}).get("total_s", 0.0),
        "refill_s": phases.get("serve.ready_queue", {}).get("total_s", 0.0),
    }

    # (c) Fleet re-home: two hubs over one sqlite file.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    fleet = None
    telemetry.enable(telemetry.MetricsRegistry())
    try:
        storage = RDBStorage(f"sqlite:///{os.path.join(tmp, 'fleet.db')}")
        names = ["hub-0", "hub-1"]
        fleet = FakeHubFleet(storage, names, lambda name: SuggestService(
            storage, factory, ready_ahead=0, coalesce_window_s=0.0, checkpoint_every=SERVE_CKPT_EVERY,
            health_reporting=False))
        ot.create_study(storage=fleet.mounted[names[0]], study_name="fleet", sampler=RandomSampler()).add_trials(history)
        sid = storage.get_study_id_from_name("fleet")
        owner = fleet.router.hub_for(sid)
        survivor = next(h for h in names if h != owner)
        thin = fleet.thin_client(seed=0)
        study = ot.load_study(study_name="fleet", storage=fleet.mounted[owner], sampler=thin)
        trial_s: list[float] = []

        def run(count):
            for _ in range(count):
                t0 = time.perf_counter()
                study.optimize(hartmann20, n_trials=1)
                torch.cuda.synchronize()
                trial_s.append(time.perf_counter() - t0)

        before = k1_count()
        run(SERVE_FLEET_TRIALS // 2)
        fleet.drop_response(owner, "service_ask", 1)
        run(SERVE_FLEET_TRIALS - SERVE_FLEET_TRIALS // 2)
        k1_owner = k1_count() - before
        replayed = int(telemetry.snapshot()["counters"].get("serve.fleet.ask_replayed", 0))
        lease_before = read_lease(storage, sid)
        fleet.kill(owner)
        before = k1_count()
        run(SERVE_AFTER_KILL)
        k1_survivor = k1_count() - before
        counters = telemetry.snapshot()["counters"]
        lease = read_lease(storage, sid)
        check_served("phase 35(c)", study, SERVE_HISTORY, SERVE_FLEET_TRIALS + SERVE_AFTER_KILL, [thin])
        if replayed != 1 or k1_owner != SERVE_FLEET_TRIALS:
            fail(f"phase 35(c): {replayed} replayed asks and {k1_owner} owner dispatches (K1) over "
                 f"{SERVE_FLEET_TRIALS} trials with one dropped answer, expected 1 and {SERVE_FLEET_TRIALS}")
        if (lease_before or {}).get("owner") != owner or lease is None or \
                (lease["owner"], lease["epoch"]) != (survivor, lease_before["epoch"] + 1):
            fail(f"phase 35(c): lease {lease_before} then {lease}, expected the epoch bumped to {survivor}")
        if counters.get("checkpoint.warm_load", 0) != 1 or counters.get("serve.fleet.hub_rehome", 0) != 1:
            fail(f"phase 35(c): warm_load {counters.get('checkpoint.warm_load', 0)}, hub_rehome "
                 f"{counters.get('serve.fleet.hub_rehome', 0)}, expected 1 each")
        if k1_survivor != SERVE_AFTER_KILL:
            fail(f"phase 35(c): K1 launched {k1_survivor} times over the survivor's {SERVE_AFTER_KILL} asks")
    finally:
        telemetry.disable()
        if fleet is not None:
            fleet.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["fleet"] = {
        "trial_ms": [round(s * 1e3, 1) for s in trial_s], "cold_first_ms": trial_s[0] * 1e3,
        "warm_first_ms": trial_s[SERVE_FLEET_TRIALS] * 1e3, "epochs": (lease_before["epoch"], lease["epoch"]),
        "k1": k1_owner + k1_survivor, "writes": int(counters.get("checkpoint.write", 0)),
    }
    out["k1"] = out["twin"]["k1"] + k1_b + out["fleet"]["k1"]
    out["s"] = time.perf_counter() - t_phase
    c, f = out["coalesced"], out["fleet"]
    print(
        f"phase 35, config #2's GP served from the card (Hartmann-20D, {SERVE_HISTORY} seeded, SGPR m 256, "
        f"handler-direct dispatcher): (a) width-1 twin of {SERVE_TWIN_TRIALS} trials identical to the local "
        f"GPSampler(seed=0) study, {out['twin']['served_ms']:.1f} ms a served trial against {out['twin']['local_ms']:.1f} "
        f"local (service_ask ms {out['twin']['ask_ms']}); (b) {n} clients x {SERVE_ASKS} asks in {c['wall_s']:.3f} s "
        f"({c['ms_per_trial']:.1f} ms a served trial): {c['dispatches']} coalesced dispatches (width max "
        f"{c['width_max']}, {c['coalesce_s']:.3f} s) and {c['refills']} refills ({c['refill_s']:.3f} s), ready queue "
        f"{c['hits']} hits / {c['misses']} misses, service_ask p50 {c['p50_ms']:.2f} ms p99 {c['p99_ms']:.2f} ms, "
        f"rounds {[round(x, 3) for x in rounds_s]} s; a third round under the profiler (queue emptied: "
        f"{c['round3'][0]} coalesced dispatches, {c['round3'][1]} refills) {c['profiled_s']:.3f} s, device busy "
        f"{c['busy_ms']:.1f} ms ({100 * c['busy_share']:.1f}%, {c['kernels']} device events, read back in "
        f"{c['readback_s']:.2f} s), K1 {c['k1']}; (c) fleet of 2 over sqlite: one dropped answer replayed, lease "
        f"epoch {f['epochs'][0]} -> {f['epochs'][1]}, warm_load 1, {f['writes']} ckpt:hub writes, first dispatch "
        f"cold {f['cold_first_ms']:.1f} ms and warm after the re-home {f['warm_first_ms']:.1f} ms (ms a trial "
        f"{f['trial_ms']}); K1 {out['k1']}; phase {out['s']:.1f} s"
    )
    return out


# ------------------------------------------------ CPU twins in a helper process


def hv_front() -> tuple[np.ndarray, np.ndarray]:
    """Phase 7's 5-objective front: 512 ``RandomState(0)`` uniform points."""
    return np.random.RandomState(0).uniform(0.0, 1.0, size=(512, 5)), np.ones(5)


def cpu_hypervolume() -> tuple:
    """Phase 7's twin: the hypervolume with ``device="cpu"`` (the plain stack
    loop), its seconds and stack iterations."""
    from optuna_tpu_torch.hypervolume import compute_hypervolume
    from optuna_tpu_torch.ops import wfg

    front, ref = hv_front()
    wfg.reset_stats()
    t0 = time.perf_counter()
    hv = compute_hypervolume(front, ref, device="cpu")
    return hv, time.perf_counter() - t0, dict(wfg.STATS)


def cpu_hssp() -> tuple:
    """Phase 21's twin at M = 5: the greedy HSSP with ``device="cpu"`` and
    its seconds. The helper has the CPU to itself, so the plain stack loop
    batches all candidates in one lockstep chunk (its bits do not depend on
    the chunk)."""
    from optuna_tpu_torch.ops.hypervolume import solve_hssp_device
    from optuna_tpu_torch.ops.kernels import wfg as stack

    front = np.random.RandomState(0).uniform(0.0, 1.0, size=(HSSP_N, HSSP_M))
    stack._PLAIN_ELEMENTS = 1 << 24
    t0 = time.perf_counter()
    picks = solve_hssp_device(front, np.ones(HSSP_M), HSSP_K, device="cpu")
    return picks, time.perf_counter() - t0


def cpu_terminator() -> dict:
    """Phase 33's twins: ``RegretBoundEvaluator`` and ``EMMREvaluator`` with
    ``device="cpu"`` over :func:`analysis_study`, value and seconds each."""
    from optuna_tpu_torch.terminator import EMMREvaluator, RegretBoundEvaluator

    study = analysis_study()
    trials = study.get_trials(deepcopy=False)
    out = {}
    for cls in (RegretBoundEvaluator, EMMREvaluator):
        t0 = time.perf_counter()
        value = cls(device="cpu").evaluate(trials, study.direction)
        out[cls.__name__] = (value, time.perf_counter() - t0)
    return out


def cpu_mo_parity() -> dict:
    """Phase 28's twins: one LogEHVI ask with ``device="cpu"`` from
    ``MO_PARITY_FROM`` seeded trials a route (:func:`first_proposal`)."""
    return {
        label: first_proposal(objective, dim, n_obj, MO_PARITY_FROM, "cpu")
        for label, objective, dim, n_obj, _, _ in mo_routes()
    }


CPU_TWINS = (
    ("hv", cpu_hypervolume), ("hssp", cpu_hssp), ("mo_parity", cpu_mo_parity), ("terminator", cpu_terminator),
)


def _run_cpu_twins(queue) -> None:
    import optuna_tpu_torch

    # The card phases' host work comes first. The thread count stays torch's
    # default, as in the main process: the LogEHVI and terminator twins'
    # results move with it (far inside their tolerances, but near ties part).
    os.nice(10)
    optuna_tpu_torch.logging.set_verbosity(optuna_tpu_torch.logging.WARNING)
    for name, fn in CPU_TWINS:
        try:
            queue.put((name, True, fn()))
        except Exception as err:  # reported to the phase that waits for it, which fails
            queue.put((name, False, repr(err)))


class CpuTwins:
    """One helper process (``spawn``: it inherits no CUDA state, and its
    twins run on the CPU only) computing :data:`CPU_TWINS` in order while
    the card's phases run. :meth:`get` waits for a twin's result, and fails
    if the helper failed it or died."""

    def __init__(self) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._proc = ctx.Process(target=_run_cpu_twins, args=(self._queue,), daemon=True)
        self._proc.start()
        self._got: dict = {}

    def get(self, name: str):
        import queue

        while name not in self._got:
            try:
                key, ok, value = self._queue.get(timeout=5.0)
            except queue.Empty:
                if not self._proc.is_alive():
                    fail(f"the CPU twins' helper process ended (exit code {self._proc.exitcode}) before {name!r}")
                continue
            self._got[key] = (ok, value)
        ok, value = self._got[name]
        if not ok:
            fail(f"CPU twin {name!r} raised {value}")
        return value

    def close(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=10.0)


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
    twins = CpuTwins()
    pod = PodRanks()
    t_start = time.perf_counter()

    phase_build()
    # The dominance-matrix and one-node WFG kernels keep their rows (checks
    # and timings) with the launches the paths made of them: none.
    rows = [
        phase_matern(device), phase_nds(device), phase_nds_rank(device), phase_wfg_kernel(device),
        phase_wfg_stack(device),
    ]
    hssp_stack_check(device)
    phase_small_sparse(device)
    phase_sobol_device(device, gpu)

    def reset():
        for k in KERNELS:
            setattr(wrappers[k["name"]], k.get("counter", "LAUNCHES"), 0)

    def counts():
        return {k["name"]: getattr(wrappers[k["name"]], k.get("counter", "LAUNCHES")) for k in KERNELS}

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
    hv_s = phase_hv(twins)
    hv = counts()
    t_scan = time.perf_counter()
    phase_scan_chunk(device)
    reset()
    k1_count = lambda: wrappers["matern52_gram"].LAUNCHES  # noqa: E731
    scan_fresh = phase_scan_fresh(k1_count)
    scan_exact = phase_scan_exact(k1_count, profile_asks)
    scan_sparse = phase_scan_sparse(k1_count, profile_asks)
    scan = counts()
    print(f"scan phases 8-11: {time.perf_counter() - t_scan:.1f} s, set-up and checks included")
    t_tpe = time.perf_counter()
    reset()
    tpe = phase_tpe(gpu)
    phase_tpe_asks("univariate", tpe["univariate"]["study"], joint=False)
    phase_tpe_asks("multivariate", tpe["multivariate+group+constant liar"]["study"], joint=True)
    phase_hyperband(gpu)
    phase_default()
    tpe_counts = counts()  # the single-objective TPE paths run no kernel of the repo
    reset()
    motpe = phase_motpe(wrappers["nds_rank"], gpu)
    motpe_counts = counts()
    print(f"TPE phases 12-16: {time.perf_counter() - t_tpe:.1f} s, set-up and checks included")
    t_runtime = time.perf_counter()
    reset()
    threads_tpe = phase_threads_tpe(gpu)
    threads_gp = phase_threads_gp(k1_count)
    threads_nsga = phase_threads_nsga(wrappers["nds_rank"], nsga_s)
    phase_wrappers(gpu)
    runtime = counts()
    print(f"runtime phases 18-19: {time.perf_counter() - t_runtime:.1f} s, set-up and checks included")
    t_slice = time.perf_counter()
    reset()
    phase_slicing()
    hssp = phase_hssp(wrappers["wfg_stack"], twins)
    hssp_counts = counts()
    reset()
    nsga3 = phase_nsga3(wrappers["nds_rank"])
    nsga3_counts = counts()
    reset()
    motpe3 = phase_motpe3(wrappers["wfg_stack"], gpu)
    motpe3_counts = counts()
    print(f"multi-objective phases 20-23: {time.perf_counter() - t_slice:.1f} s, set-up and checks included")
    t_cma = time.perf_counter()
    reset()
    cma = phase_cmaes(gpu)
    cma_counts = counts()
    print(f"CMA-ES phase 24: {time.perf_counter() - t_cma:.1f} s, set-up and checks included")
    t_gp = time.perf_counter()
    reset()
    chain = phase_chain(k1_count, exact_s, sparse_s)
    running = phase_running(k1_count)
    constrained = phase_constraints(k1_count)
    mo_gp = phase_mo_gp(k1_count, twins)
    gp_rest = counts()
    print(f"GP phases 25-28: {time.perf_counter() - t_gp:.1f} s, set-up and checks included")
    t_batch = time.perf_counter()
    reset()
    mlp5 = phase_mlp(gpu)
    phase_containment()
    batch_counts = counts()  # config #5's TPE and MLP and the containment cases run no kernel of the repo
    reset()
    gp_batches = phase_gp_batches(k1_count)
    gp_batch_counts = counts()
    print(f"batch phases 29-31: {time.perf_counter() - t_batch:.1f} s, set-up and checks included")
    t_resume = time.perf_counter()
    reset()
    resume = phase_resume(k1_count)
    resume_counts = counts()
    print(f"resume phase 32: {time.perf_counter() - t_resume:.1f} s, set-up and checks included")
    t_analysis = time.perf_counter()
    reset()
    analysis = phase_analysis(k1_count, wrappers["wfg_stack"], twins)
    twins.close()
    analysis_counts = counts()
    print(f"analysis phase 33: {time.perf_counter() - t_analysis:.1f} s, set-up and checks included")
    reset()
    control = phase_autopilot(k1_count)
    control_counts = counts()
    print(f"observability and control phase 34: {control['s']:.1f} s, set-up and checks included")
    reset()
    serve = phase_serve(k1_count)
    serve_counts = counts()
    print(f"serve phase 35: {serve['s']:.1f} s, set-up and checks included")
    reset()
    sharded = phase_sharded(pod, gpu)
    sharded_counts = counts()
    print(f"sharded phase 36: {sharded['s']:.1f} s, set-up and checks included")
    if any(sharded_counts.values()):
        fail(f"phase 36 launched kernels of the repo: {sharded_counts}")
    if serve_counts["matern52_gram"] != serve["k1"] or any(v for k, v in serve_counts.items() if k != "matern52_gram"):
        fail(f"phase 35 launched {serve_counts}, expected K1 {serve['k1']} and no other kernel")
    if control_counts["matern52_gram"] != control["k1"] or any(v for k, v in control_counts.items() if k != "matern52_gram"):
        fail(f"phase 34 launched {control_counts}, expected K1 {control['k1']} and no other kernel")
    want_analysis = dict.fromkeys(analysis_counts, 0)
    want_analysis.update(matern52_gram=analysis["k1"], wfg_stack=analysis["k3"])
    if analysis_counts != want_analysis:
        fail(f"phase 33 launched {analysis_counts}, expected {want_analysis}")
    if resume_counts["matern52_gram"] != resume["k1"] or any(v for k, v in resume_counts.items() if k != "matern52_gram"):
        fail(f"phase 32 launched {resume_counts}, expected K1 {resume['k1']} and no other kernel")
    if any(batch_counts.values()):
        fail(f"phases 29-30 launched kernels of the repo: {batch_counts}")
    if gp_batch_counts["matern52_gram"] != GP_BATCHES or any(v for k, v in gp_batch_counts.items() if k != "matern52_gram"):
        fail(f"phase 31 launched {gp_batch_counts}, expected K1 {GP_BATCHES} and no other kernel")
    k1_rest = (chain["sparse"]["k1"] + chain["sparse"]["k1_batch"] + running["sparse"]["k1"]
               + sum(o["k1"] for o in constrained.values()))
    if gp_rest["matern52_gram"] != k1_rest or any(v for k, v in gp_rest.items() if k != "matern52_gram"):
        fail(f"GP phases 25-28 launched {gp_rest}, expected K1 {k1_rest} and no other kernel")
    if any(cma_counts.values()):
        fail(f"the CMA-ES paths launched kernels of the repo: {cma_counts}")
    if any(tpe_counts.values()):
        fail(f"the single-objective TPE paths launched kernels: {tpe_counts}")
    launches = {
        "matern52_gram": gp["matern52_gram"] + scan["matern52_gram"] + runtime["matern52_gram"]
        + gp_rest["matern52_gram"] + gp_batch_counts["matern52_gram"] + resume_counts["matern52_gram"]
        + analysis_counts["matern52_gram"] + control_counts["matern52_gram"] + serve_counts["matern52_gram"],
        "nds_rank": nsga["nds_rank"] + motpe["launches"] + runtime["nds_rank"] + nsga3_counts["nds_rank"]
        + motpe3_counts["nds_rank"],
        "wfg_stack": hv["wfg_stack"] + runtime["wfg_stack"] + hssp_counts["wfg_stack"] + nsga3_counts["wfg_stack"]
        + motpe3_counts["wfg_stack"] + analysis_counts["wfg_stack"],
    }
    print(
        f"launches on the paths: {launches} (GP exact {after_exact}, sparse {sparse_launches} over "
        f"{8 + int(profile_asks)} asks; NSGA-II {nsga}; hypervolume {hv}; scan {scan}: K1 fresh "
        f"{scan_fresh['k1']}, exact {scan_exact['k1']}, sparse {scan_sparse['k1']} over "
        f"{scan_sparse['chunks']} chunks and {int(scan_sparse['gauges']['device.gp.inducing_swaps.total'])} swaps"
        f"{', profiled chunks included' if profile_asks else ''}; MOTPE K2 {motpe['launches']}; runtime phases "
        f"{runtime}: K1 {threads_gp['k1']} over the threaded sparse asks, K2 {threads_nsga['ranks']} from the "
        f"NSGA-II workers); slicing and HSSP {hssp_counts}; NSGA-III {nsga3_counts}; MOTPE DTLZ2 {motpe3_counts}; "
        f"GP phases 25-28: K1 {gp_rest['matern52_gram']} = chain {chain['sparse']['k1']} + batch "
        f"{chain['sparse']['k1_batch']}, running {running['sparse']['k1']}, constraints "
        f"{constrained[4000]['k1']}, LogEHVI 0; phase 31: K1 {gp_batches['k1']} over {GP_BATCHES} batches; "
        f"phase 32: K1 {resume['k1']} over the killed, resumed and twin scans; phase 33: K1 {analysis['k1']} = "
        f"terminator {analysis['terminator']['k1']} + GP study with the callback {analysis['callbacks']['k1']}, "
        f"K3 {analysis['k3']} over the hypervolume history's routed prefixes; phase 34: K1 {control['k1']} over the "
        f"act run's 5 SGPR chunks and the twins' 4, swap-ins included; phase 35: K1 {serve['k1']} = twin "
        f"{serve['twin']['k1']} + coalesced {serve['coalesced']['k1']} + fleet {serve['fleet']['k1']}, one a hub "
        f"dispatch)"
    )
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} never launched on its path")
    if sparse_launches < 8:
        fail(f"matern52_gram launched {sparse_launches} times over the sparse asks")
    if launches["nds_rank"] < 2:
        fail(f"nds_rank launched {launches['nds_rank']} times over NSGA-II generations 2 and 3")
    if hv["wfg_stack"] != 2:
        fail(f"wfg_stack launched {hv['wfg_stack']} times on the hypervolume path, expected 1 per hypervolume and 1 "
             "per leave-one-out")
    if hssp_counts["wfg_stack"] != HSSP_K or launches["wfg_stack"] != 2 + HSSP_K + analysis["k3"]:
        fail(f"wfg_stack launched {hssp_counts['wfg_stack']} times on the HSSP path, expected {HSSP_K} (one a greedy "
             f"step), and {launches['wfg_stack']} in all")
    paths = (gp, nsga, hv, scan, motpe_counts, runtime, hssp_counts, nsga3_counts, motpe3_counts, cma_counts, gp_rest,
             batch_counts, gp_batch_counts, resume_counts, analysis_counts, control_counts, serve_counts, sharded_counts)
    per_node = sum(c["wfg_limit_filter"] for c in paths)
    if per_node:
        fail(f"the one-node WFG kernel launched {per_node} times on the paths: the stack kernel runs every node")
    launches["wfg_limit_filter"] = per_node
    matrix = sum(c["nds"] for c in paths)
    if matrix:
        fail(f"the dominance-matrix kernel launched {matrix} times on the paths: the ranking kernels rank")
    launches["nds"] = matrix
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_thresholds()

    print(
        f"gpu: {gpu} | exact median {float(np.median(exact_s)):.4f} s/ask, "
        f"sparse median {float(np.median(sparse_s)):.4f} s/ask, NSGA-II {nsga_s:.2f} s, "
        f"hypervolume {hv_s:.2f} s, scan {scan_exact['s_per_chunk']:.3f} s per exact chunk "
        f"({scan_exact['trials_per_s']:.2f} trials/s), {scan_sparse['s_per_chunk']:.3f} s per sparse chunk "
        f"({scan_sparse['trials_per_s']:.2f} trials/s), TPE highdim_mixed {tpe['univariate']['card_ms']:.3f} "
        f"ms/trial (CPU torch {tpe['univariate']['cpu_ms']:.3f}), MOTPE {motpe['ms']:.3f} ms/trial from 512 "
        f"trials, TPE n_jobs=1/{RUNTIME_JOBS} {threads_tpe[1]['ms']:.3f}/{threads_tpe[RUNTIME_JOBS]['ms']:.3f} "
        f"ms/trial, warm sparse GP asks sequential {threads_gp['seq_ask_s']:.3f} s / at n_jobs=2 "
        f"{threads_gp['thr_ask_s']:.3f} s an ask, NSGA-II n_jobs={RUNTIME_JOBS} {threads_nsga['ms']:.3f} ms/trial, "
        f"HSSP 512x5 k=16 {hssp[HSSP_M]['card_s']:.3f} s, NSGA-III {nsga3['ms']:.3f} ms/trial, MOTPE DTLZ2 "
        f"{motpe3['ms']:.3f} ms/trial through the device HSSP, CMA-ES config #3 {cma['ms']:.3f} ms/trial (CPU torch "
        f"{cma['cpu_ms']:.3f}), GP config #2 chain {chain['exact']['ms']:.1f} / {chain['sparse']['ms']:.1f} ms/trial "
        f"at n={CHAIN_EXACT_FROM} / {CHAIN_SPARSE_FROM}, qLogEI n_jobs=2 {running[2]['s'] / running[2]['trials']:.3f} "
        f"s/trial ({running[2]['qlogei_ask_s']:.3f} s a qLogEI ask), qLogEI {running['exact']['s']:.3f} / {running['sparse']['s']:.3f} s/ask, constrained "
        f"{float(np.median(constrained[1000]['s'])):.3f} / {float(np.median(constrained[4000]['s'])):.3f} s/ask, "
        f"LogEHVI ZDT1 {float(np.median(mo_gp['ZDT1']['s'])):.3f} / DTLZ2 {float(np.median(mo_gp['DTLZ2']['s'])):.3f} "
        f"s/ask, config #5 {mlp5['trials_per_s']:.1f} trials/s ({mlp5['gflops']:.1f} GFLOP/s in a "
        f"{mlp5['batch_ms']:.3f} ms batch), GP batches of {GP_BATCH} {gp_batches['s'] / GP_BATCHES:.3f} s, "
        f"scan resume {resume['runs_s'][1]:.3f} s (restore {resume['restore_s']:.4f} s), "
        f"fANOVA at n={ANALYSIS_HISTORY} {analysis['importance']['fANOVA']['card_s'][1] * 1e3:.1f} ms (CPU torch "
        f"{analysis['importance']['fANOVA']['cpu_s'] * 1e3:.1f}), regret bound "
        f"{analysis['terminator']['RegretBoundEvaluator']['card_s']:.3f} s (CPU torch "
        f"{analysis['terminator']['RegretBoundEvaluator']['cpu_s']:.3f}), "
        f"autopilot scan {control['per_chunk']['on']:.3f} s an SGPR chunk with every hook on, "
        f"{control['per_chunk']['off']:.3f} with every hook off (gp.densify {control['verdict']}), "
        f"served GP {serve['coalesced']['ms_per_trial']:.1f} ms a trial at {SERVE_CLIENTS} clients (coalesce width "
        f"max {serve['coalesced']['width_max']}), "
        f"config #5 sharded {sharded['a']['trials_per_s']['sharded']:.1f} trials/s (twin "
        f"{sharded['a']['trials_per_s']['twin']:.1f}), "
        f"total {time.perf_counter() - t_start:.1f} s"
    )
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
