# graphlint fixture: STO002 negatives — consistent order and reentrancy.
import threading

lock_a = threading.Lock()
lock_b = threading.Lock()


class Store:
    def __init__(self):
        self._lock = threading.RLock()

    def reentrant_ok(self):
        with self._lock:
            with self._lock:  # same lock: RLock reentrance, not an order edge
                pass


def ordered_one():
    with lock_a:
        with lock_b:
            pass


def ordered_two():
    with lock_a:
        with lock_b:
            pass


def register_callback(callbacks):
    # A function *defined* under lock_b runs later, lock-free: no b->a edge.
    with lock_b:
        def cb():
            with lock_a:
                pass

        callbacks.append(cb)


class _Channel:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


# "cv" only counts as a whole underscore-separated token: `recv` is a
# socket-shaped name, not a condition variable. If it were mislabelled a
# lock, these two orders would fabricate a cycle.
recv = _Channel()


def recv_one_way():
    with lock_a:
        with recv:
            pass


def recv_other_way():
    with recv:
        with lock_a:
            pass


cond_state = threading.Condition()


def cond_consistent_one():
    with lock_a:
        with cond_state:
            pass


def cond_consistent_two():
    with lock_a:
        with cond_state:
            pass
