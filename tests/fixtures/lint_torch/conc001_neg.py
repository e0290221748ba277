# graphlint fixture: CONC001 negatives — helper-mediated acquisitions that
# keep one global order, calls made with nothing held, and the depth-1
# contract (a chain two helpers deep is out of scope by design).
import threading


class Store:
    def __init__(self):
        self._lock_a = threading.Lock()
        self._lock_b = threading.Lock()

    def forward(self):
        with self._lock_a:
            self._grab_b()  # a -> b, same direction as the lexical path

    def _grab_b(self):
        with self._lock_b:
            pass

    def also_forward(self):
        with self._lock_a:
            with self._lock_b:
                pass

    def lock_free_call(self):
        self._grab_a()  # nothing held: no edge from following this call

    def _grab_a(self):
        with self._lock_a:
            pass

    def callback_under_lock(self, callbacks):
        with self._lock_b:
            # Defined under the lock != executed under it: the callback's
            # self-call is not followed with lock_b in the held set.
            callbacks.append(lambda: self._grab_a())

    def two_deep(self):
        with self._lock_b:
            self._via_middleman()  # depth 1 stops here: _grab_a's b -> a
            # inversion two hops down is deliberately out of scope
            # (deeper chains are the runtime sanitizer's job).

    def _via_middleman(self):
        self._grab_a()
