# graphlint fixture: CONC002 positives — blocking work inside a lock's
# critical section (the suggestion-service p99 regression class).
import time
import threading


class Server:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._storage = None
        self._worker_thread = None
        self._fut = None

    def sleepy(self):
        with self._lock:
            time.sleep(0.5)  # EXPECT: CONC002

    def storage_under_lock(self, trial_id):
        with self._lock:
            self._storage.set_trial_system_attr(trial_id, "k", "v")  # EXPECT: CONC002

    def join_under_lock(self):
        with self._lock:
            self._worker_thread.join()  # EXPECT: CONC002

    def future_under_lock(self):
        with self._lock:
            return self._fut.result()  # EXPECT: CONC002

    def foreign_wait(self):
        with self._lock:
            with self._cond:
                self._cond.wait()  # EXPECT: CONC002

    def rpc_under_lock(self, req):
        with self._lock:
            return self._call("Ask", req)  # EXPECT: CONC002

    def _call(self, method, req):
        return (method, req)

    def via_helper(self):
        with self._lock:
            self._drain()  # inlined one level: the verdict anchors below

    def _drain(self):
        time.sleep(0.1)  # EXPECT: CONC002
