# graphlint fixture: PY001 positives.


def broad(fn):
    try:
        return fn()
    except Exception:  # EXPECT: PY001
        return None


def bare(fn):
    try:
        return fn()
    except:  # EXPECT: PY001
        return None


def tupled(fn):
    try:
        return fn()
    except (ValueError, Exception):  # EXPECT: PY001
        return None


def base(fn):
    try:
        return fn()
    except BaseException:  # EXPECT: PY001
        return None
