# graphlint fixture: float64 and TF32 in a device module (TPU003). The
# config classifies this file as a device module.
import numpy as np
import torch


def widen(x):
    a = x.to(torch.float64)  # EXPECT: TPU003
    b = x.to(dtype=torch.double)  # EXPECT: TPU003
    c = x.double()  # EXPECT: TPU003
    d = np.zeros(3, dtype=np.float64)  # EXPECT: TPU003
    e = np.asarray(x, dtype="float64")  # EXPECT: TPU003
    return a, b, c, d, e


def switch_on_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True  # EXPECT: TPU003
    torch.backends.cudnn.allow_tf32 = True  # EXPECT: TPU003
    torch.set_float32_matmul_precision("high")  # EXPECT: TPU003
    torch.backends.cuda.matmul.fp32_precision = "tf32"  # EXPECT: TPU003
