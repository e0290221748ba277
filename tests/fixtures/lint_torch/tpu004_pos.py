# graphlint fixture: stray debug output in package code (TPU004).
import pdb


def noisy(x):
    print("debug", x)  # EXPECT: TPU004
    breakpoint()  # EXPECT: TPU004
    pdb.set_trace()  # EXPECT: TPU004
    return x
