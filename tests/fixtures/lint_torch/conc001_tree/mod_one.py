# graphlint fixture: CONC001 cross-module half — this module only ever
# acquires a then b. The inversion lives in mod_two.py; only the merged
# package-wide graph (same class name -> same lock labels) sees the cycle.
import threading


class Store:
    def __init__(self):
        self._lock_a = threading.Lock()
        self._lock_b = threading.Lock()

    def forward(self):
        with self._lock_a:
            with self._lock_b:  # EXPECT: CONC001
                pass
