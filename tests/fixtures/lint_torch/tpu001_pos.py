# graphlint fixture: host reads inside registered device programs (TPU001).
# The config registers chunk_program and Solver.run as device programs.
import torch


def chunk_program(x, n):
    y = x * 2
    v = y.sum().item()  # EXPECT: TPU001
    flag = bool(torch.all(y > 0))  # EXPECT: TPU001
    rows = y.tolist()  # EXPECT: TPU001
    host = y.cpu()  # EXPECT: TPU001
    arr = y.numpy()  # EXPECT: TPU001
    moved = y.to("cpu")  # EXPECT: TPU001
    moved_too = y.to(device=torch.device("cpu"))  # EXPECT: TPU001
    scale = float(y[0])  # EXPECT: TPU001
    torch.cuda.synchronize()  # EXPECT: TPU001

    def step(z):
        return int(z.max())  # EXPECT: TPU001

    return step(y), v, flag, rows, host, arr, moved, moved_too, scale


class Solver:
    def run(self, x):
        return x.item()  # EXPECT: TPU001
