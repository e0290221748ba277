# graphlint fixture: CONC002 negatives — blocking work that is fine (done
# lock-free, or the wait that releases the only held lock) and the
# look-alikes that must not fire (string/path joins, deferred callbacks).
import os
import time
import threading


class Server:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._storage = None
        self._parts = ["a", "b"]
        self._fut = None

    def sleep_outside(self):
        time.sleep(0.5)  # nothing held

    def storage_outside(self, trial_id):
        self._storage.set_trial_system_attr(trial_id, "k", "v")

    def own_cond_wait(self):
        # Waiting on the condition you hold is THE condition-variable
        # pattern: wait releases it for the whole window.
        with self._cond:
            self._cond.wait(timeout=0.1)

    def string_join_under_lock(self):
        with self._lock:
            return ", ".join(self._parts)  # str.join is formatting

    def path_join_under_lock(self, a, b):
        with self._lock:
            return os.path.join(a, b)  # os.path.join never blocks

    def future_outside(self):
        return self._fut.result()

    def callback_under_lock(self, callbacks):
        with self._lock:
            # Registered now, runs later lock-free: the sleep inside the
            # callback is not "under" this lock.
            def flush():
                time.sleep(0.1)

            callbacks.append(flush)
