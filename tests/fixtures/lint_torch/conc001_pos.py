# graphlint fixture: CONC001 positive — the order inversion is invisible to
# a purely lexical scan (STO002): one direction of the cycle lives behind a
# helper method called under the outer lock.
import threading


class Store:
    def __init__(self):
        self._lock_a = threading.Lock()
        self._lock_b = threading.Lock()

    def forward(self):
        with self._lock_a:
            self._grab_b()  # inlined one level: records the a -> b edge

    def _grab_b(self):
        with self._lock_b:  # EXPECT: CONC001
            pass

    def backward(self):
        with self._lock_b:
            with self._lock_a:  # the lexical b -> a edge closes the cycle
                pass
