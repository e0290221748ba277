# graphlint fixture: CONC001 cross-module half — the opposite order of
# mod_one.py. Each module is acyclic alone; the merged graph is not. The
# cycle is anchored at its lexically-first edge, which sorts into mod_one.
import threading


class Store:
    def __init__(self):
        self._lock_a = threading.Lock()
        self._lock_b = threading.Lock()

    def backward(self):
        with self._lock_b:
            with self._lock_a:
                pass
