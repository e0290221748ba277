"""locksan: an opt-in TSan-lite lock-order sanitizer for the serve stack
(port of ``optuna_tpu/locksan.py``, standard library only).

This module proves lock discipline at runtime. Every named lock in the
package's serve/observability stack is constructed through the factories
here (:func:`lock`, :func:`rlock`, :func:`condition`), under a name from
the vocabulary :data:`LOCK_NAMES` (the reference's, name for name).

Armed (``OPTUNA_TPU_TORCH_LOCKSAN=1``, or :func:`enable` in tests), the factories
return instrumented wrappers that record each thread's acquisition order,
maintain one global happens-before lock graph, and report — *at acquire
time, even when no interleaving actually deadlocks*:

* ``lock_order_cycle`` — this acquire adds an edge that closes a cycle in
  the happens-before graph: two threads taking these locks in opposite
  orders deadlock under the right interleaving.
* ``held_across_blocking`` — a :meth:`Condition.wait` (which releases only
  its own lock) or a declared :func:`blocking` operation ran while other
  sanitized locks stayed held: every waiter on those locks convoys behind
  the blocking window (the measured 17x p99 regression class).

Verdicts surface three ways: the structured :func:`report` JSON, a
``locksan.verdict.<kind>`` telemetry counter per verdict, and a flight
postmortem dump of the recorder tail (when the flight recorder is armed).

Disabled — the default — the factories return *bare* ``threading``
primitives: the sanitized-off hot path has zero per-acquire Python
overhead and zero per-acquire allocations, the same disabled contract
telemetry spans and flight events honor (asserted with ``tracemalloc`` in
``tests/test_torch_observability.py``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Iterator

__all__ = [
    "LOCK_NAMES",
    "blocking",
    "condition",
    "disable",
    "enable",
    "enabled",
    "lock",
    "report",
    "reset",
    "rlock",
]

#: The sanitizer's accepted lock names, equal to the reference's (a factory
#: call outside the vocabulary raises while armed).
LOCK_NAMES: frozenset[str] = frozenset(
    {
        "suggest.shed",
        "suggest.coalesce",
        "suggest.ready_queue",
        "suggest.handle",
        "suggest.handles",
        "suggest.inflight",
        "suggest.refill",
        "suggest.thin_client",
        "server.op_token",
        "fleet.liveness",
        "fleet.adopt",
        "fleet.lease",
        "fleet.peer",
        "telemetry.registry",
        "flight.jit_totals",
        "autopilot.step",
        "health.doctor",
        "slo.engine",
    }
)

#: Verdicts kept in the in-memory report (the telemetry counter keeps the
#: true total; the report is a bounded diagnostic, like the flight ring).
_MAX_VERDICTS = 256

_enabled = bool(os.environ.get("OPTUNA_TPU_TORCH_LOCKSAN"))

_tls = threading.local()

# Internal state, guarded by a bare (never sanitized) lock: the sanitizer
# must not instrument itself.
_state_lock = threading.Lock()
_edges: dict[str, set[str]] = {}
_edge_sites: dict[tuple[str, str], str] = {}
_verdicts: list[dict] = []
_reported: set = set()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Arm the sanitizer (tests; production arms via ``OPTUNA_TPU_TORCH_LOCKSAN=1``
    before import). Only locks *constructed while armed* are instrumented —
    arming never retrofits existing bare locks."""
    global _enabled
    reset()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear the happens-before graph and all recorded verdicts."""
    with _state_lock:
        _edges.clear()
        _edge_sites.clear()
        _verdicts.clear()
        _reported.clear()


def report() -> dict:
    """The structured verdict report: every recorded verdict plus the
    happens-before graph observed so far (JSON-able by construction)."""
    with _state_lock:
        return {
            "enabled": _enabled,
            "verdicts": [dict(v) for v in _verdicts],
            "edges": {a: sorted(bs) for a, bs in sorted(_edges.items())},
        }


def verdicts(kind: str | None = None) -> list[dict]:
    """Recorded verdicts, optionally filtered by kind."""
    with _state_lock:
        return [dict(v) for v in _verdicts if kind is None or v["kind"] == kind]


# ----------------------------------------------------------- thread state


def _stack() -> list[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _emit(kind: str, name: str, held: list[str], dedupe_key: Any, **details) -> None:
    """Record one verdict (report + counter + flight postmortem), once per
    dedupe key. Reentrancy-guarded: counting a verdict takes the telemetry
    registry lock, which may itself be sanitized — instrumentation is off
    while reporting."""
    with _state_lock:
        if dedupe_key in _reported:
            return
        _reported.add(dedupe_key)
        verdict = {
            "kind": kind,
            "lock": name,
            "held": list(held),
            "thread": threading.current_thread().name,
            **details,
        }
        if len(_verdicts) < _MAX_VERDICTS:
            _verdicts.append(verdict)
    _tls.reporting = True
    try:
        from optuna_tpu_torch import flight, telemetry

        telemetry.count("locksan.verdict." + kind)
        flight.postmortem("locksan." + kind, key=f"locksan:{kind}:{name}")
    finally:
        _tls.reporting = False


def _find_path(src: str, dst: str) -> list[str] | None:
    """A src ->* dst path in the happens-before graph (caller holds
    ``_state_lock``); None when unreachable."""
    parents: dict[str, str] = {src: src}
    frontier = [src]
    while frontier:
        nxt: list[str] = []
        for node in frontier:
            for succ in _edges.get(node, ()):
                if succ in parents:
                    continue
                parents[succ] = node
                if succ == dst:
                    path = [dst]
                    while path[-1] != src:
                        path.append(parents[path[-1]])
                    path.reverse()
                    return path
                nxt.append(succ)
        frontier = nxt
    return None


def _note_acquire(name: str) -> None:
    """Record the happens-before edges this acquire implies and report any
    cycle they close — BEFORE blocking on the lock, so a potential deadlock
    is reported even on the interleavings that get lucky."""
    held = _stack()
    for holder in reversed(held):
        if holder == name:
            continue  # reentrant re-acquire (RLock): not an order edge
        with _state_lock:
            known = name in _edges.get(holder, ())
            if not known:
                _edges.setdefault(holder, set()).add(name)
                _edge_sites[(holder, name)] = threading.current_thread().name
            # A cycle exists iff the lock being acquired already reaches a
            # held lock: name ->* holder plus the new holder -> name edge.
            path = _find_path(name, holder)
        if path is not None:
            cycle = path + [name]
            _emit(
                "lock_order_cycle",
                name,
                list(held),
                frozenset(cycle),
                cycle=cycle,
                detail=(
                    "acquiring "
                    + name
                    + " while holding "
                    + holder
                    + " closes the cycle "
                    + " -> ".join(cycle)
                    + "; the opposite order was observed on another path"
                ),
            )


def _note_acquired(name: str) -> None:
    _stack().append(name)


def _note_release(name: str) -> None:
    stack = _stack()
    # Pop the last occurrence: RLock reentrancy pushes the name twice.
    for idx in range(len(stack) - 1, -1, -1):
        if stack[idx] == name:
            del stack[idx]
            return


def _check_blocking(op: str, own: str | None = None) -> None:
    """Report held-across-blocking when any sanitized lock other than
    ``own`` (a Condition's own lock, released by its wait) is held."""
    others = [n for n in _stack() if n != own]
    if others:
        _emit(
            "held_across_blocking",
            own if own is not None else op,
            others,
            ("blocking", op, tuple(sorted(set(others)))),
            operation=op,
            detail=(
                f"'{op}' blocks while [{', '.join(sorted(set(others)))}] "
                "stay held; every waiter on those locks convoys behind it"
            ),
        )


def _instrumenting() -> bool:
    return _enabled and not getattr(_tls, "reporting", False)


# -------------------------------------------------------------- wrappers


class _SanLock:
    """A named, instrumented ``threading.Lock`` (or RLock) stand-in."""

    __slots__ = ("_name", "_inner")

    def __init__(self, name: str, inner: Any) -> None:
        self._name = name
        self._inner = inner

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _instrumenting():
            _note_acquire(self._name)
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                _note_acquired(self._name)
            return ok
        return self._inner.acquire(blocking, timeout)

    def release(self) -> None:
        self._inner.release()
        if _instrumenting():
            _note_release(self._name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<locksan {type(self._inner).__name__} {self._name!r}>"


class _SanCondition(threading.Condition):
    """A named, instrumented ``threading.Condition``: acquisition order is
    tracked like any lock, and a ``wait`` while other sanitized locks stay
    held is a held-across-blocking verdict (wait releases only its own
    lock; the others block every waiter for the whole window)."""

    def __init__(self, name: str) -> None:
        super().__init__()
        self._san_name = name

    def __enter__(self) -> bool:
        if _instrumenting():
            _note_acquire(self._san_name)
            ok = super().__enter__()
            _note_acquired(self._san_name)
            return ok
        return super().__enter__()

    def __exit__(self, *exc: object) -> None:
        super().__exit__(*exc)
        if _instrumenting():
            _note_release(self._san_name)

    def wait(self, timeout: float | None = None) -> bool:
        if _instrumenting():
            _check_blocking(f"{self._san_name}.wait", own=self._san_name)
        return super().wait(timeout)


def _check_name(name: str) -> None:
    if name not in LOCK_NAMES:
        raise ValueError(
            f"locksan lock name {name!r} is not in the canonical vocabulary; "
            "register it in locksan.LOCK_NAMES."
        )


def lock(name: str):
    """A named mutex. Disabled: a bare ``threading.Lock`` (zero wrap, zero
    per-acquire overhead). Armed: an instrumented stand-in."""
    if not _enabled:
        return threading.Lock()
    _check_name(name)
    return _SanLock(name, threading.Lock())


def rlock(name: str):
    """A named reentrant mutex; reentrant re-acquires are not order edges."""
    if not _enabled:
        return threading.RLock()
    _check_name(name)
    return _SanLock(name, threading.RLock())


def condition(name: str):
    """A named condition variable (its ``with`` acquires a lock like any
    other; its ``wait`` is a held-across-blocking check)."""
    if not _enabled:
        return threading.Condition()
    _check_name(name)
    return _SanCondition(name)


class _Blocking:
    __slots__ = ("_op",)

    def __init__(self, op: str) -> None:
        self._op = op

    def __enter__(self) -> None:
        if _instrumenting():
            _check_blocking(self._op)

    def __exit__(self, *exc: object) -> None:
        return None


_NULL_BLOCKING = _Blocking("")


def blocking(op: str):
    """Declare a blocking operation (storage op, RPC, dispatch wait): armed,
    entering the context while any sanitized lock is held is a
    held-across-blocking verdict. Disabled, returns a shared inert
    singleton (the telemetry ``_NULL_SPAN`` zero-allocation contract)."""
    if not _enabled:
        return _NULL_BLOCKING
    return _Blocking(op)
