# graphlint fixture: CONC003 positive — attrs the background thread writes
# (directly, and one self-call level deep) mutated lock-free on the main
# path. The fixture config registers Worker._run as a thread entrypoint.
import threading


class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._beats = 0
        self._status = "idle"
        self._config = {}

    def _run(self):
        while True:
            self._beats += 1  # thread-side write
            self._bump_status()

    def _bump_status(self):
        self._status = "beating"  # helper one level deep: still thread-side

    def reset(self):
        self._beats = 0  # EXPECT: CONC003
        self._status = "idle"  # EXPECT: CONC003
        with self._lock:
            self._config = {}
