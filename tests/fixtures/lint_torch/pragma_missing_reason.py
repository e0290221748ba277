# graphlint fixture: a pragma without a reason suppresses nothing and is
# itself reported as LNT001.


def leaky(x):
    print("no reason given", x)  # graphlint: ignore[TPU004]
    return x
