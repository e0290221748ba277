"""Brute-force sampler over (possibly dynamic) finite spaces (port of
``optuna_tpu/samplers/_brute_force.py``).

Parity target: ``optuna/samplers/_brute_force.py:54,226`` — an incrementally
built search tree over the spaces discovered by finished trials; leaves are
parameter combinations; the sampler exhausts every leaf and stops the study.
"""

from __future__ import annotations

import decimal
from typing import TYPE_CHECKING, Any, Sequence

from optuna_tpu_torch.distributions import (
    BaseDistribution,
    CategoricalDistribution,
    FloatDistribution,
    IntDistribution,
)
from optuna_tpu_torch.logging import get_logger
from optuna_tpu_torch.samplers._base import BaseSampler
from optuna_tpu_torch.samplers._lazy_random_state import LazyRandomState
from optuna_tpu_torch.trial._frozen import FrozenTrial
from optuna_tpu_torch.trial._state import TrialState

if TYPE_CHECKING:
    from optuna_tpu_torch.study.study import Study

_logger = get_logger(__name__)


def _enumerate_candidates(param_distribution: BaseDistribution) -> list[Any]:
    if isinstance(param_distribution, FloatDistribution):
        if param_distribution.step is None:
            raise ValueError(
                "FloatDistribution.step must be given for BruteForceSampler"
                " (otherwise the space is infinite)."
            )
        low = decimal.Decimal(str(param_distribution.low))
        high = decimal.Decimal(str(param_distribution.high))
        step = decimal.Decimal(str(param_distribution.step))
        out = []
        value = low
        while value <= high:
            out.append(float(value))
            value += step
        return out
    if isinstance(param_distribution, IntDistribution):
        return list(
            range(param_distribution.low, param_distribution.high + 1, param_distribution.step)
        )
    assert isinstance(param_distribution, CategoricalDistribution)
    return list(param_distribution.choices)


class _TreeNode:
    """Search tree: nodes keyed by (param_name); edges by candidate value.

    A leaf (empty children) is a fully-specified configuration. The tree is
    rebuilt from trial history each ask, so it works across processes.
    ``running`` marks a leaf currently held by a RUNNING trial so parallel
    workers can steer around (or wait on) it.
    """

    __slots__ = ("param_name", "children", "running")

    def __init__(self) -> None:
        self.param_name: str | None = None
        self.children: dict[Any, "_TreeNode"] | None = None
        self.running = False

    def expand(self, param_name: str | None, candidates: Sequence[Any]) -> None:
        if self.children is None:
            self.param_name = param_name
            self.children = {c: _TreeNode() for c in candidates}
        else:
            if self.param_name != param_name:
                raise ValueError(
                    f"Inconsistent parameter order detected: {self.param_name} != {param_name}. "
                    "BruteForceSampler requires the objective to suggest deterministically "
                    "given earlier parameters."
                )

    def set_leaf(self) -> None:
        self.expand(None, [])

    def add_path(
        self, params_and_search_spaces: list[tuple[str, list[Any], Any]]
    ) -> "_TreeNode | None":
        node = self
        for param_name, candidates, value in params_and_search_spaces:
            node.expand(param_name, candidates)
            assert node.children is not None
            if value not in node.children:
                return None
            node = node.children[value]
        return node

    def count_unexpanded(self, exclude_running: bool = False) -> int:
        if self.children is None:
            return 0 if (exclude_running and self.running) else 1
        if len(self.children) == 0:
            return 0
        return sum(c.count_unexpanded(exclude_running) for c in self.children.values())

    def sample_child(self, rng) -> Any:
        assert self.children is not None
        keys = list(self.children.keys())
        # Prefer branches with work no other (running) worker has claimed;
        # fall back to any unexpanded branch, then uniform.
        for exclude_running in (True, False):
            weights = [
                c.count_unexpanded(exclude_running) for c in self.children.values()
            ]
            total = sum(weights)
            if total > 0:
                r = rng.rand() * total
                acc = 0.0
                for k, w in zip(keys, weights):
                    acc += w
                    if r <= acc:
                        return k
                return keys[-1]
        return keys[rng.randint(len(keys))]


class BruteForceSampler(BaseSampler):
    def __init__(self, seed: int | None = None, avoid_premature_stop: bool = False) -> None:
        self._rng = LazyRandomState(seed)
        self._avoid_premature_stop = avoid_premature_stop

    def reseed_rng(self) -> None:
        self._rng.seed()

    @staticmethod
    def _populate_tree(
        trials: list[FrozenTrial], treat_finished: frozenset[int] = frozenset()
    ) -> _TreeNode:
        tree = _TreeNode()
        for trial in trials:
            leaf = tree.add_path(
                [
                    (
                        name,
                        _enumerate_candidates(trial.distributions[name]),
                        trial.params[name],
                    )
                    for name in trial.params
                ]
            )
            if leaf is not None:
                if trial.state.is_finished() or trial.number in treat_finished:
                    leaf.set_leaf()
                elif trial.state == TrialState.RUNNING:
                    leaf.running = True
        return tree

    def sample_independent(
        self,
        study: "Study",
        trial: FrozenTrial,
        param_name: str,
        param_distribution: BaseDistribution,
    ) -> Any:
        trials = study._get_trials(deepcopy=False, use_cache=True)
        tree = self._populate_tree(
            [t for t in trials if t.number != trial.number]
        )
        candidates = _enumerate_candidates(param_distribution)
        # Walk the tree along the current trial's params to this decision point.
        node = tree.add_path(
            [
                (
                    name,
                    _enumerate_candidates(trial.distributions[name]),
                    trial.params[name],
                )
                for name in trial.params
                if name != param_name
            ]
        )
        if node is None:
            node = _TreeNode()
        node.expand(param_name, candidates)
        return node.sample_child(self._rng.rng)

    def after_trial(
        self,
        study: "Study",
        trial: FrozenTrial,
        state: TrialState,
        values: Sequence[float] | None,
    ) -> None:
        trials = study.get_trials(
            deepcopy=False,
            states=(
                TrialState.COMPLETE,
                TrialState.PRUNED,
                TrialState.RUNNING,
                TrialState.FAIL,
            ),
        )
        # The trial being told is still RUNNING in storage; count it as
        # finished without mutating the shared record.
        tree = self._populate_tree(trials, treat_finished=frozenset({trial.number}))
        # With avoid_premature_stop, in-flight (running) combinations keep the
        # study alive until they actually finish (reference _brute_force.py:339).
        if tree.count_unexpanded(exclude_running=not self._avoid_premature_stop) == 0:
            study.stop()
