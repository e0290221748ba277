# graphlint fixture: f32 numerics with TF32 off, and float64 only inside an
# allowlisted host boundary (no TPU003).
import numpy as np
import torch


def narrow(x):
    return x.to(torch.float32), np.zeros(3, dtype=np.float32)


def switch_off_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def allowed_host_boundary(x):
    return np.asarray(x, dtype=np.float64), x.double().cpu().numpy()
