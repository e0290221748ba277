"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``)."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch


def t32(a, dtype=torch.float32) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor."""
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype)


def np64(t) -> np.ndarray:
    """tensor or JAX array -> float64 numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a test module's torch work, restored after.

    The port's CPU tests run many small ops (L-BFGS iterations on
    16-128-row matrices). The driver runs six pytest workers on the
    machine's cores, and torch's default of one intra-op thread a core
    then puts several spinning threads on every core: a GP route file took
    544 s in a full six-worker run and 28 s alone. One thread is faster
    alone too (24 s) and changes no check: each test compares within one
    process, at one thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device() -> torch.device:
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


# ------------------------------------------------- TPE: the reference's draws


@functools.lru_cache(maxsize=1)
def _jax_tpe_draw_programs():
    """The reference's TPE draws (``optuna_tpu/samplers/_tpe/_kernels.py``:
    ``PRNGKey(seed)`` split per numerical dim, ``fold_in(key, 1)`` split per
    categorical dim, each key split in 3 for component, uniform and
    categorical; ``jax.random.categorical`` is ``argmax(logits + gumbel)``),
    as jit programs static in the shapes."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
    def univariate(seed, n_num, n_cat, s, b, c):
        key = jax.random.PRNGKey(seed)

        def num(k):
            k_comp, k_num, _ = jax.random.split(k, 3)
            return jax.random.gumbel(k_comp, (s, b), jnp.float32), jax.random.uniform(k_num, (s, 1))

        def cat(k):
            k_comp, _, k_cat = jax.random.split(k, 3)
            return jax.random.gumbel(k_comp, (s, b), jnp.float32), jax.random.gumbel(k_cat, (s, 1, c), jnp.float32)

        g_num, u_num = jax.vmap(num)(jax.random.split(key, n_num)) if n_num else (
            jnp.zeros((0, s, b)), jnp.zeros((0, s, 1)))
        g_comp, g_cat = jax.vmap(cat)(jax.random.split(jax.random.fold_in(key, 1), n_cat)) if n_cat else (
            jnp.zeros((0, s, b)), jnp.zeros((0, s, 1, c)))
        return g_num, u_num, g_comp, g_cat

    @partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
    def joint(seed, n_num, n_cat, s, b, c):
        k_comp, k_num, k_cat = jax.random.split(jax.random.PRNGKey(seed), 3)
        return (
            jax.random.gumbel(k_comp, (s, b), jnp.float32),
            jax.random.uniform(k_num, (s, n_num)),
            jax.random.gumbel(k_cat, (s, n_cat, c), jnp.float32),
        )

    return univariate, joint


def jax_univariate_draws(seed, n_num, n_cat, n_samples, n_components, cmax, device):
    """The reference's univariate draws for ``seed``, as the port's
    ``univariate_draws`` lays them out."""
    from optuna_tpu_torch.samplers._tpe._kernels import Draws

    univariate, _ = _jax_tpe_draw_programs()
    g_num, u_num, g_comp, g_cat = (
        torch.as_tensor(np.array(a)).to(device)
        for a in univariate(np.uint32(seed), n_num, n_cat, n_samples, n_components, cmax)
    )
    return (
        Draws(g_num, u_num, g_num.new_zeros((n_num, n_samples, 0, cmax))),
        Draws(g_comp, g_comp.new_zeros((n_cat, n_samples, 0)), g_cat),
    )


def jax_joint_draws(seed, n_num, n_cat, n_samples, n_components, cmax, device):
    """The reference's multivariate (and top-k) draws for ``seed``."""
    from optuna_tpu_torch.samplers._tpe._kernels import Draws

    _, joint = _jax_tpe_draw_programs()
    comp, uniform, cat = (
        torch.as_tensor(np.array(a))[None].to(device)
        for a in joint(np.uint32(seed), n_num, n_cat, n_samples, n_components, cmax)
    )
    return Draws(comp, uniform, cat)


@pytest.fixture
def reference_tpe_draws(monkeypatch):
    """Hand the reference's draws to every TPE ask of the port."""
    from optuna_tpu_torch.samplers._tpe import _kernels

    monkeypatch.setattr(_kernels, "univariate_draws", jax_univariate_draws)
    monkeypatch.setattr(_kernels, "joint_draws", jax_joint_draws)


# --------------------------------------------- CMA-ES: the reference's draws


def jax_cma_draws(seed, fold, n, d, device):
    """The reference's ask draws, ``normal(fold_in(PRNGKey(seed), fold), (n, d))``
    (``optuna_tpu/samplers/_cmaes.py``), laid out as the port's
    ``ask_draws`` returns them."""
    import jax

    key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    return torch.as_tensor(np.array(jax.random.normal(key, (n, d), dtype=np.float32))).to(device)


@pytest.fixture
def reference_cma_draws(monkeypatch):
    """Hand the reference's draws to every CMA-ES ask of the port."""
    from optuna_tpu_torch.ops import cmaes

    monkeypatch.setattr(cmaes, "ask_draws", jax_cma_draws)


# ------------------------------------------- heartbeats the test can steer


def heartbeat_storage(pkg, interval=60, failed_trial_callback=None):
    """An in-memory storage of ``pkg`` with the heartbeat mixin, for tests
    that count beats or choose which trials are stale (tests that follow a
    reference test over RDB use ``RDBStorage``): beats are counted per
    trial, and the trials named in ``stale`` are stale while RUNNING, as a
    dead worker's are once its beats age past the grace period."""

    class HeartbeatStorage(pkg.storages.InMemoryStorage, pkg.storages.BaseHeartbeat):
        def __init__(self) -> None:
            super().__init__()
            self.beats: dict[int, int] = {}
            self.stale: set[int] = set()

        def record_heartbeat(self, trial_id):
            self.beats[trial_id] = self.beats.get(trial_id, 0) + 1

        def _get_stale_trial_ids(self, study_id):
            return sorted(t for t in self.stale if self.get_trial(t).state == pkg.TrialState.RUNNING)

        def get_heartbeat_interval(self):
            return interval

        def get_failed_trial_callback(self):
            return failed_trial_callback

    return HeartbeatStorage()


@pytest.fixture(scope="module")
def join_abandoned_dispatches():
    """Join, after a test module, the dispatch threads its deadline tests
    abandoned (both packages name them ``optuna-tpu-dispatch``). A thread
    that wakes from its injected hang while the interpreter shuts down
    dies inside the framework's C++ frames and aborts the process; joined
    here, it finishes its call first."""
    import threading

    yield
    for thread in threading.enumerate():
        if thread.name == "optuna-tpu-dispatch":
            thread.join(timeout=30.0)


# --------------------------------------------- storages: one op sequence, two packages


def run_op_sequence(pkg, storage, seed: int) -> dict:
    """Drive ``storage`` (a storage of ``pkg``) through one op sequence drawn
    from ``RandomState(seed)``: two studies, their attrs, and trials in
    every state with params of each distribution, intermediate values
    (NaN and ±inf among them) and attrs. Returns the first study's fields
    and trials as the storage reads them back."""
    rng = np.random.RandomState(seed)
    dists = pkg.distributions
    SD = pkg.study.StudyDirection
    TS = pkg.trial.TrialState
    directions = [[SD.MINIMIZE], [SD.MAXIMIZE], [SD.MINIMIZE, SD.MAXIMIZE]][rng.randint(3)]
    name = f"ops-{seed}"
    sid = storage.create_new_study(directions, study_name=name)
    other = storage.create_new_study([SD.MINIMIZE], study_name=f"other-{seed}")
    storage.set_study_user_attr(sid, "lr", float(rng.uniform()))
    storage.set_study_user_attr(sid, "tags", ["a", int(rng.randint(100))])
    storage.set_study_system_attr(sid, "note", "seeded")
    space = {
        "f": dists.FloatDistribution(-3.0, 3.0),
        "lg": dists.FloatDistribution(1e-5, 1.0, log=True),
        "st": dists.FloatDistribution(0.0, 1.0, step=0.125),
        "i": dists.IntDistribution(1, 64, step=3),
        "c": dists.CategoricalDistribution(["a", 7, None, 2.5]),
    }
    specials = [float("nan"), float("inf"), -float("inf")]
    for k in range(8):
        if k % 4 == 3:
            tid = storage.create_new_trial(
                sid, template_trial=pkg.trial.create_trial(state=TS.WAITING, params={}, distributions={})
            )
        else:
            tid = storage.create_new_trial(sid)
        storage.create_new_trial(other)
        for pname, dist in space.items():
            if rng.uniform() < 0.8:
                if isinstance(dist, dists.CategoricalDistribution):
                    internal = float(rng.randint(len(dist.choices)))
                elif isinstance(dist, dists.IntDistribution):
                    internal = float(dist.low + dist.step * rng.randint((dist.high - dist.low) // dist.step + 1))
                elif dist.step is not None:
                    internal = float(dist.step * rng.randint(9))
                else:
                    internal = float(np.exp(rng.uniform(np.log(dist.low), np.log(dist.high))) if dist.log else rng.uniform(dist.low, dist.high))
                storage.set_trial_param(tid, pname, internal, dist)
        for step in range(rng.randint(4)):
            value = specials[step] if rng.uniform() < 0.3 else float(rng.normal())
            storage.set_trial_intermediate_value(tid, step, value)
        storage.set_trial_user_attr(tid, "k", int(k))
        storage.set_trial_system_attr(tid, "ckpt:op", f"r0:c{k}:0")
        state = [TS.COMPLETE, TS.FAIL, TS.PRUNED, TS.RUNNING, TS.COMPLETE][rng.randint(5)]
        if state != TS.RUNNING or k % 4 == 3:
            values = [float(rng.normal()) for _ in directions] if state == TS.COMPLETE else None
            if k % 4 == 3:
                storage.set_trial_state_values(tid, TS.RUNNING)
            storage.set_trial_state_values(tid, state, values)
    return {
        "study_name": name,
        "directions": [d.name for d in directions],
        "study_user_attrs": storage.get_study_user_attrs(sid),
        "study_system_attrs": storage.get_study_system_attrs(sid),
        "trials": storage.get_all_trials(sid),
    }


def _same_float(a, b) -> bool:
    return (a is None and b is None) or (a is not None and b is not None and (a == b or (a != a and b != b)))


def assert_same_trials(a: dict, b: dict) -> None:
    """Every ``FrozenTrial`` field of two read-backs equal (NaN equal to NaN,
    distributions by their JSON form, datetimes by presence)."""
    ta, tb = a["trials"], b["trials"]
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert (x.number, x.state.name) == (y.number, y.state.name)
        assert (x.values is None) == (y.values is None)
        if x.values is not None:
            assert x.values == y.values
        assert x.params == y.params
        json_x = {k: type(d).__name__ + repr(sorted(vars(d).items())) for k, d in x.distributions.items()}
        json_y = {k: type(d).__name__ + repr(sorted(vars(d).items())) for k, d in y.distributions.items()}
        assert json_x == json_y
        assert x.user_attrs == y.user_attrs
        assert x.system_attrs == y.system_attrs
        assert sorted(x.intermediate_values) == sorted(y.intermediate_values)
        for step, v in x.intermediate_values.items():
            assert _same_float(v, y.intermediate_values[step]), (step, v, y.intermediate_values[step])
        assert (x.datetime_start is None) == (y.datetime_start is None)
        assert (x.datetime_complete is None) == (y.datetime_complete is None)


# --------------------------------- the forest and EMMR: the reference's draws


def jax_bootstrap_weights(n_trees: int, n: int, seed) -> torch.Tensor:
    """The reference's bootstrap (``optuna_tpu/ops/forest.py``): per tree,
    ``choice(key, n, (n,))`` from ``split(PRNGKey(seed), n_trees)``, as the
    (n_trees, n) weights the port's ``_grow_trees`` takes."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.PRNGKey(0 if seed is None else seed), n_trees)

    def one(key):
        return jnp.zeros(n, jnp.float32).at[jax.random.choice(key, n, shape=(n,))].add(1.0)

    return torch.as_tensor(np.array(jax.vmap(one)(keys)))


@pytest.fixture
def reference_forest_draws(monkeypatch):
    """Hand the reference's bootstrap to every forest the port grows."""
    from optuna_tpu_torch.ops import forest

    monkeypatch.setattr(forest, "_bootstrap_weights", jax_bootstrap_weights)


def jax_emmr_normals(n_samples: int, n: int, seed: int) -> np.ndarray:
    """The reference EMMR's normals, ``normal(PRNGKey(seed), (n_samples, n))``
    (``optuna_tpu/terminator/_evaluators.py``)."""
    import jax

    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n_samples, n)))


@pytest.fixture
def reference_emmr_normals(monkeypatch):
    """Hand the reference's normals to every EMMR evaluation of the port."""
    from optuna_tpu_torch.terminator import _evaluators

    monkeypatch.setattr(_evaluators, "_emmr_normals", jax_emmr_normals)


def _split_gain(members, weights, y, left) -> float:
    """Σ_l²/n_l + Σ_r²/n_r of one split of a node's samples, in float64."""
    w = np.where(members, weights, 0.0)
    cl, cr = w[left].sum(), w[~left].sum()
    sl, sr = (w * y)[left].sum(), (w * y)[~left].sum()
    return sl * sl / cl + sr * sr / cr


def assert_forests_agree(
    ref_trees, port_trees, X, y_std, weights, *, scale=1.0, atol=1e-5, gain_rtol=1e-6
) -> int:
    """Hold two forests' exported trees (``DeviceTree``) to each other, tree
    for tree and node for node: the same feature and threshold, and node
    count, value and impurity within ``atol`` (values in units of the
    target's ``scale`` plus their own size, impurities of ``scale**2``, the
    float32 rescale of the export). Where a node's split parts, it
    must be a near tie: the two splits' gains over the node's samples
    (float64, standardized target ``y_std``, bootstrap ``weights`` (T, n))
    within ``gain_rtol`` relative, or, where one side keeps a leaf, the
    other's gain within ``gain_rtol`` of the split threshold (the parent's
    score plus 1e-7). The subtree below a parting is not compared. Returns
    the number of partings."""
    X = np.asarray(X, np.float64)
    y_std = np.asarray(y_std, np.float64)
    weights = np.asarray(weights, np.float64)
    assert len(ref_trees) == len(port_trees)
    partings = 0
    for t, (rt, pt) in enumerate(zip(ref_trees, port_trees)):
        r, p = rt.tree_, pt.tree_
        n_nodes = len(r.feature)
        assert len(p.feature) == n_nodes
        members = {0: np.ones(len(X), bool)}
        for k in range(n_nodes):
            if k not in members:
                continue  # under a parting or never reached
            for name, a, b, tol in (
                ("count", r.n_node_samples, p.n_node_samples, atol),
                ("value", r.value, p.value, atol * (scale + abs(r.value[k]))),
                ("impurity", r.impurity, p.impurity, atol * scale * scale),
            ):
                assert abs(a[k] - b[k]) <= tol, (t, k, name, a[k], b[k])
            m = members.pop(k)
            same = r.feature[k] == p.feature[k] and (r.feature[k] < 0 or r.threshold[k] == p.threshold[k])
            if same:
                if r.feature[k] >= 0:
                    left = X[:, r.feature[k]] < r.threshold[k]
                    members[2 * k + 1], members[2 * k + 2] = m & left, m & ~left
                continue
            partings += 1
            gains = [
                _split_gain(m, weights[t], y_std, X[:, tr.feature[k]] < tr.threshold[k])
                for tr in (r, p)
                if tr.feature[k] >= 0
            ]
            if len(gains) == 1:  # a leaf on one side: the split test's own threshold
                w = np.where(m, weights[t], 0.0)
                gains.append((w * y_std).sum() ** 2 / w.sum() + 1e-7)
            assert abs(gains[0] - gains[1]) <= gain_rtol * max(abs(gains[0]), 1.0), (t, k, gains)
    return partings


# ------------------------------------------------ the serve tier: both packages


def mount(pkg, storage, service=None):
    """Mount ``storage`` (and a suggestion ``service``) behind ``pkg``'s server
    request path with no socket: the port's grpc-free dispatcher
    (``testing.fault_injection.mount_dispatch``), or the reference's gRPC
    handler called directly. Returns ``(mounted storage, rpc(method, *args,
    **kwargs))``; an error answer raises."""
    import types

    from importlib import import_module

    if pkg.__name__ == "optuna_tpu_torch":
        from optuna_tpu_torch.testing.fault_injection import mount_dispatch

        return mount_dispatch(storage, service)
    wire = import_module(pkg.__name__ + ".storages._grpc._service")
    server = import_module(pkg.__name__ + ".storages._grpc.server")
    mounted = service.wrap_storage(storage) if service is not None else storage
    method_handler = server._make_handler(mounted, service).service(
        types.SimpleNamespace(method=f"/{wire.SERVICE_NAME}/x")
    )

    def rpc(method, *args, **kwargs):
        ok, payload = wire.decode_response(method_handler.unary_unary(wire.encode_request(method, args, kwargs), None))
        if not ok:
            raise payload
        return payload

    return mounted, rpc


def thin_ask(pkg, rpc):
    """A ``ThinClientSampler`` ask callable over ``rpc`` (op token riding
    the wire as the thin client sends it): the port's
    ``testing.fault_injection.thin_client_ask`` for either ``pkg``, since
    both packages name the token kwarg alike (``test_torch_grpc_wire``)."""
    from optuna_tpu_torch.testing.fault_injection import thin_client_ask

    return thin_client_ask(rpc)


def stub_sampler(pkg, seed: int = 0, *, startup: int = 2, fail_with: BaseException | None = None):
    """A ``pkg`` sampler whose relative proposals are draws of one
    ``RandomState(seed)`` over a fixed two-float space (after ``startup``
    COMPLETE trials): the same proposals in both packages, so a serve-tier
    decision sequence is compared with no model in the way. Each batch
    width it was asked for lands in ``.widths``; ``fail_with`` is raised by
    every relative call instead."""
    d = pkg.distributions
    space = {"x": d.FloatDistribution(0.0, 1.0), "y": d.FloatDistribution(-1.0, 1.0)}

    class Stub(pkg.samplers.BaseSampler):
        def __init__(self):
            self.rng = np.random.RandomState(seed)
            self.widths: list[int] = []

        def infer_relative_search_space(self, study, trial):
            done = study._get_trials(deepcopy=False, states=(pkg.trial.TrialState.COMPLETE,), use_cache=False)
            return dict(space) if len(done) >= startup else {}

        def _draw(self, search_space):
            if fail_with is not None:
                raise fail_with
            return {k: float(space[k].low + (space[k].high - space[k].low) * self.rng.uniform()) for k in sorted(search_space)}

        def sample_relative(self, study, trial, search_space):
            self.widths.append(1)
            return self._draw(search_space) if search_space else {}

        def sample_relative_batch(self, study, search_space, batch_size):
            self.widths.append(batch_size)
            return [self._draw(search_space) for _ in range(batch_size)]

        def sample_independent(self, study, trial, param_name, param_distribution):
            return float(self.rng.uniform(param_distribution.low, param_distribution.high))

    return Stub()


def serve_objective(trial) -> float:
    x = trial.suggest_float("x", 0.0, 1.0)
    y = trial.suggest_float("y", -1.0, 1.0)
    return (x - 0.3) ** 2 + (y + 0.2) ** 2
