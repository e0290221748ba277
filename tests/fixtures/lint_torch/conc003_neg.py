# graphlint fixture: CONC003 negatives — main-path writes under a lock,
# writes to attrs the thread never touches, construction-time writes
# (happens-before Thread.start), and deferred-callback writes.
import threading


class Worker:
    def __init__(self):
        # Construction happens-before the thread starts: never flagged.
        self._lock = threading.Lock()
        self._beats = 0
        self._config = {}

    def _run(self):
        while True:
            self._beats += 1

    def reset(self):
        with self._lock:
            self._beats = 0  # locked on the main path: fine

    def configure(self, config):
        self._config = dict(config)  # the thread never writes _config

    def callback_factory(self):
        def on_flush():
            self._beats = 99  # runs on whoever flushes, not collected here

        return on_flush
