"""Batched trials of config #5 in a closed loop: TPE asks a batch of
``batch_size`` trials, ``optimize_vectorized`` trains them all in one
dispatch of ``optuna_tpu_torch.models.mlp.train_scaled_batch``, and tells
the batch back. A study runs the configuration's ``study_trials``, then a
new study starts from the next sub-seed; the restarts are in the window.

The data (examples, labels of a seeded linear teacher, initial weights) is
made on the device from the seed, and the reference trains on the same
tensors. The check, once the window has closed:

- the trainer: a seeded sample of the window's trials is retrained one at
  a time by :mod:`bench_port.reference.mlp` in float32 and in float64, and
  the stored losses' relative errors against float64 are compared, at
  their median and at their 85th percentile, with the float32
  retraining's own errors at the same percentile
  (``loss_err_q50_ratio``, ``loss_err_q85_ratio``): the 85th percentile
  moves with a fault in a sixth or more of a batch's rows;
- the batch ask: for a seeded sample of the window's TPE batches, the
  reference (:mod:`bench_port.reference.tpe`) rebuilds ``l(x)`` and
  ``g(x)`` from the study's trials before the batch and makes batch asks
  of its own over them; ``ask_ks`` is the largest Kolmogorov-Smirnov
  distance, over the score ``log l - log g`` and each parameter, between
  a batch's proposals and the reference's;
- a trial of the window that did not complete counts in ``failed_trials``.

The history the ask is judged on is the program's own (its stored
parameters and losses); the losses' check covers how they were made.
"""

from __future__ import annotations

import math

import numpy as np

from bench_port.harness import log


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device) -> None:
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.batch = int(traffic["batch_size"])
        self.counts: dict[str, int] = {"batch_trials": 0}
        self.attempted = self.failed = 0
        self._window: list[tuple[float, float, float]] = []  # (lr, init_scale, value) of COMPLETE trials
        self._batches: set[tuple[int, int]] = set()  # (study, batch) of the window's trials
        self._all_studies: list = []

    def setup(self) -> None:
        import torch

        import optuna_tpu_torch as ot
        from optuna_tpu_torch.distributions import FloatDistribution
        from optuna_tpu_torch.models.mlp import MLPParams, train_scaled_batch
        from optuna_tpu_torch.parallel import VectorizedObjective

        ot.logging.set_verbosity(ot.logging.WARNING)
        c = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.random.default_rng([self.seed, 0]).integers(2**63 - 1)))
        n, n_in, h, n_out = (int(c[k]) for k in ("n_examples", "n_in", "n_hidden", "n_out"))
        dev = self.device
        self.x = torch.rand((n, n_in), generator=gen, device=dev)
        teacher = torch.randn((n_in, n_out), generator=gen, device=dev)
        self.labels = torch.argmax((self.x - 0.5) @ teacher, dim=1)
        std = float(c["init_std"])
        self.base = MLPParams(
            w1=torch.randn((n_in, h), generator=gen, device=dev) * std,
            b1=torch.zeros(h, device=dev),
            w2=torch.randn((h, n_out), generator=gen, device=dev) * std,
            b2=torch.zeros(n_out, device=dev),
        )
        steps = int(c["sgd_steps"])
        x, labels, base = self.x, self.labels, self.base

        def train(params: dict) -> torch.Tensor:
            return train_scaled_batch(base, x, labels, params["lr"], params["init_scale"], steps)

        space = {
            name: FloatDistribution(float(s["low"]), float(s["high"]), log=bool(s["log"]))
            for name, s in c["space"].items()
        }
        self.objective = VectorizedObjective(fn=train, search_space=space)
        self._new_study()
        self._run(int(self.traffic["warm_batches"]) * self.batch)

    def _new_study(self) -> None:
        import optuna_tpu_torch as ot
        from optuna_tpu_torch.samplers import TPESampler

        seed = int(np.random.default_rng([self.seed, 1, len(self._all_studies)]).integers(2**31 - 1))
        self.study = ot.create_study(sampler=TPESampler(seed=seed, device=self.device, **self.config["sampler"]))
        self._all_studies.append(self.study)
        self.done = 0

    def _run(self, n: int, callbacks=()) -> None:
        from optuna_tpu_torch.parallel import optimize_vectorized

        before = len(self.study.get_trials(deepcopy=False))
        optimize_vectorized(
            self.study, self.objective, n_trials=n, batch_size=self.batch, callbacks=list(callbacks),
            device=self.device,
        )
        self.done += len(self.study.get_trials(deepcopy=False)) - before

    def run_window(self, seconds: float, clock) -> None:
        from optuna_tpu_torch.trial import TrialState

        def tally(study, frozen) -> None:
            self.attempted += 1
            self._batches.add((len(self._all_studies) - 1, frozen.number // self.batch))
            if frozen.state == TrialState.COMPLETE:
                self.counts["batch_trials"] += 1
                self._window.append((frozen.params["lr"], frozen.params["init_scale"], float(frozen.value)))
            else:
                self.failed += 1
            # The callbacks of a batch run once all its trials are terminal,
            # so a stop at the batch's last one cuts no batch.
            if self.attempted % self.batch == 0 and clock.now() >= seconds:
                study.stop()

        with clock:
            while True:
                total = int(self.config["study_trials"])
                if self.done >= total:
                    self._new_study()
                self._run(total - self.done, callbacks=[tally])
                if clock.now() >= seconds:
                    break

    def release(self) -> None:
        judge = self.config["judge"]
        k = min(int(judge["trials"]), len(self._window))
        rng = np.random.default_rng([self.seed, 2])
        self._judged = [self._window[i] for i in sorted(rng.choice(len(self._window), size=k, replace=False))]
        # Batch 0 of a study is its random start-up; the others are TPE's.
        tpe = sorted(b for b in self._batches if b[1] >= 1)
        k = min(int(judge["batches"]), len(tpe))
        picked = [tpe[i] for i in sorted(np.random.default_rng([self.seed, 3]).choice(len(tpe), size=k, replace=False))]
        self._asks = [ask_of(self._all_studies[s], b, self.batch, self.config["space"]) for s, b in picked]
        self.study = self.objective = self._all_studies = None

    def check(self) -> dict:
        r = readings(self._judged, self.x, self.labels, self.base, int(self.config["sgd_steps"]))
        log(f"judged {len(self._judged)} trials: {r}")
        asks = ask_readings(self._asks, self.config, self.batch, self.seed, self.device)
        log(f"judged {len(self._asks)} batch asks: {asks}")
        r.update(asks)
        r["failed_trials"] = float(self.failed)
        return {name: {"value": r[name], "limit": float(limit)} for name, limit in self.config["limits"].items()}


def readings(judged, x, labels, base, steps: int, control: bool = False) -> dict:
    """Each judged trial is retrained by the reference in float32 (TF32
    off) and in float64, from its ``lr`` and ``init_scale`` as the trainer
    got them (float32). Of the relative errors against the float64
    retraining: the median and the 85th percentile of the stored losses',
    each over the same percentile of the float32 retraining's own
    (``loss_err_q50_ratio``, ``loss_err_q85_ratio``), so that the same
    trials' sensitivity to rounding stands on both sides; and, printed
    only, the median and the largest relative gap between a stored loss and
    the float32 retraining, with the largest one's trial. With ``control``,
    the same of the reference trained with TF32 products in the stored
    losses' place."""
    import torch

    from bench_port.reference.mlp import train_one

    names = ("w1", "b1", "w2", "b2")
    base32 = {k: getattr(base, k) for k in names}
    base64 = {k: getattr(base, k).double() for k in names}
    x64 = x.double()

    def rel(a: float, b: float) -> float:
        err = abs(a - b) / max(abs(b), 1e-6)
        return err if math.isfinite(err) else math.inf

    stored, ref32, ref64, tf32 = [], [], [], []
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for lr, scale, value in judged:
            lr, scale = float(np.float32(lr)), float(np.float32(scale))
            torch.backends.cuda.matmul.allow_tf32 = False
            stored.append(value)
            ref32.append(train_one(base32, x, labels, lr, scale, steps))
            ref64.append(train_one(base64, x64, labels, lr, scale, steps))
            if control:
                torch.backends.cuda.matmul.allow_tf32 = True
                tf32.append(train_one(base32, x, labels, lr, scale, steps))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if not stored:
        return {"loss_err_q50_ratio": math.inf, "loss_err_q85_ratio": math.inf}
    own = [rel(r, t) for r, t in zip(ref32, ref64)]

    def summary(losses) -> dict:
        gaps = np.array([rel(v, r) for v, r in zip(losses, ref32)])
        errs = np.array([rel(v, t) for v, t in zip(losses, ref64)])
        out = {"loss_rel_err_median": float(np.median(gaps)), "loss_rel_err_max": float(np.max(gaps))}
        for name, q in (("q50", 0.5), ("q85", 0.85)):
            out[f"loss_err_{name}_ratio"] = float(np.quantile(errs, q) / max(np.quantile(own, q), 1e-12))
        return out

    out = summary(stored)
    worst = int(np.argmax([rel(v, r) for v, r in zip(stored, ref32)]))
    out.update(worst_trial_lr=float(judged[worst][0]), worst_trial_init_scale=float(judged[worst][1]))
    if control:
        out.update({"control_" + k: v for k, v in summary(tf32).items()})
    return out


def _working(value: float, spec: dict) -> float:
    """A parameter in the search space's working coordinates."""
    return math.log(value) if spec["log"] else float(value)


def ask_of(study, batch_index: int, batch: int, space: dict) -> dict:
    """What the reference needs of one batch ask: the study's finished
    trials before the batch (working coordinates, values) and the batch's
    proposals, each as an array with a column a parameter."""
    from optuna_tpu_torch.trial import TrialState

    first = batch_index * batch
    names = list(space)
    trials = study.get_trials(deepcopy=False)
    history = [t for t in trials if t.number < first and t.state == TrialState.COMPLETE]
    proposals = [t for t in trials if first <= t.number < first + batch]

    def coords(ts):
        return np.array([[_working(t.params[n], space[n]) for n in names] for t in ts], dtype=np.float64)

    return {"x": coords(history), "values": np.array([t.value for t in history], dtype=np.float64),
            "proposals": coords(proposals)}


def ask_readings(asks, config: dict, batch: int, seed: int, device="cpu", control: bool = False) -> dict:
    """``ask_ks``: over the judged asks, the largest Kolmogorov-Smirnov
    distance (score and each parameter) between an ask's proposals and the
    reference's own batch asks over the same trials; with ``control``, the
    same of proposals drawn uniformly in the search space (random sampling
    in TPE's place)."""
    from bench_port.reference import tpe

    space = config["space"]
    lows = np.array([_working(s["low"], s) for s in space.values()])
    highs = np.array([_working(s["high"], s) for s in space.values()])
    rounds = int(config["judge"]["ask_rounds"])
    dists, control_dists = [], []
    for i, ask in enumerate(asks):
        rng = np.random.default_rng([seed, 4, i])
        ratio = tpe.Ratio(ask["x"], ask["values"], lows, highs, device)
        k = len(ask["proposals"])
        dists.append(tpe.ask_distance(ratio, ask["proposals"], k, rounds, rng))
        if control:
            uniform = rng.uniform(lows, highs, size=ask["proposals"].shape)
            control_dists.append(tpe.ask_distance(ratio, uniform, k, rounds, rng))
    # No TPE batch in the window is a run that cannot be judged.
    out = {"ask_ks": max(dists, default=math.inf), "asks_judged": float(len(dists))}
    if control:
        out["control_ask_ks"] = min(control_dists, default=math.inf)
    return out
