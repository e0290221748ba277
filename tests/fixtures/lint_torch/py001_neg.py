# graphlint fixture: PY001 negatives — none of these may fire.


def narrow(fn):
    try:
        return fn()
    except ValueError:
        return None


def narrow_tuple(fn):
    try:
        return fn()
    except (KeyError, TypeError) as err:
        return err
