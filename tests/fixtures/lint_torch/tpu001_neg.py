# graphlint fixture: the same registered device programs, read-free (no
# TPU001): static metadata, literals, device-side moves, and host reads
# outside any registered program.
import torch


def chunk_program(x, n):
    rows = int(x.shape[0])
    width = int(len(x))
    inf = torch.tensor(float("inf"), device=x.device)
    on_card = x.to("cuda")
    narrow = x.to(torch.float32)
    size = int(x.size(0))
    return torch.where(x > 0, x, inf)[:rows, :width], on_card, narrow, size, n


class Solver:
    def run(self, x):
        return torch.clamp(x, min=0.0)


def host_boundary(x):
    return x.item(), x.tolist(), bool(torch.all(x > 0))
