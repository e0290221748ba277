# graphlint fixture: well-formed pragmas suppress (zero findings expected).


def hush(x):
    print("trailing pragma", x)  # graphlint: ignore[TPU004] -- fixture: reviewed output

    # graphlint: ignore[TPU004] -- fixture: own-line pragma covers the next line
    print("own-line pragma", x)
    return x
