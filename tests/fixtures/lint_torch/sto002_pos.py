# graphlint fixture: STO002 positive — two locks taken in both orders.
import threading

lock_a = threading.Lock()
lock_b = threading.Lock()


def path_one():
    with lock_a:
        with lock_b:  # EXPECT: STO002
            pass


def path_two():
    with lock_b:
        with lock_a:
            pass


# Condition-variable spellings participate in the order graph too: a
# Condition IS a lock, whatever the attribute is called.
state_cond = threading.Condition()
_cv = threading.Condition()


def cond_path_one():
    with state_cond:
        with _cv:  # EXPECT: STO002
            pass


def cond_path_two():
    with _cv:
        with state_cond:
            pass
