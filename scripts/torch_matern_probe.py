"""The Matérn-5/2 Gram kernel (K1) against its floors, on one CUDA card.

Run from the root of a checkout:

    python3 scripts/torch_matern_probe.py
    python3 scripts/torch_matern_probe.py --compare A.cu [B.cu ...]

At the GP main path's shape, Z (256, 20) x X (4096, 20), and at (256, 10000,
20), a history of ten thousand trials: the kernel of
``optuna_tpu_torch/ops/kernels/csrc/matern52_gram.cu`` (device time from
CUDA-graph replay, as ``chip_smoke.py`` times kernels), the launch floor
(the kernel at (1, 1, 20)) and the write floor (``torch.empty(n1,
n2).zero_()``), both yardsticks the port never calls. With ``--compare``,
each other revision of the source (same C interface) is built and timed in
turns with the tree's (tree, other, other, tree) at the same inputs, after a
check that both agree to 1e-6.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (graph_ms, matern_inputs, gpu_line, fail)

SHAPES = ((256, 4096, 20), (256, 10000, 20))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this probe needs a CUDA card")
    from optuna_tpu_torch.ops.kernels import _nvcc, matern

    device = torch.device("cuda", 0)
    others = []
    if "--compare" in sys.argv:
        for path in sys.argv[sys.argv.index("--compare") + 1:]:
            others.append((os.path.basename(path), _nvcc.load(os.path.abspath(path), matern.bind)))
    for n1, n2, d in SHAPES:
        args = chip_smoke.matern_inputs(n1, n2, d, 0, seed=n1 + n2 + d, device=device)
        tree = lambda: matern.matern52_gram(*args)  # noqa: E731
        ms = chip_smoke.graph_ms(tree)
        tiny = chip_smoke.matern_inputs(1, 1, d, 0, seed=1, device=device)
        launch = chip_smoke.graph_ms(lambda: matern.matern52_gram(*tiny))
        write = chip_smoke.graph_ms(lambda: torch.empty(n1, n2, device=device).zero_())
        bound = 4 * (n1 * d + n2 * d + d + 1 + n1 * n2) / chip_smoke.HBM_BYTES_PER_S * 1e3
        print(
            f"matern52_gram ({n1}, {n2}, {d}): kernel {ms:.5f} ms; floors: launch {launch:.5f} ms, write "
            f"{write:.5f} ms; bound {bound:.6f} ms (bytes) (device time, CUDA graph)"
        )
        for name, lib in others:
            alt = lambda: matern._launch(*args, lib=lib)  # noqa: E731
            if float((tree() - alt()).abs().max()) > 1e-6:
                chip_smoke.fail(f"{name} disagrees with the tree's kernel at ({n1}, {n2}, {d})")
            t = [chip_smoke.graph_ms(fn) for fn in (tree, alt, alt, tree)]
            print(f"  compare {name}: tree {t[0]:.5f} / {t[3]:.5f} ms, {name} {t[1]:.5f} / {t[2]:.5f} ms")
    print(f"gpu: {chip_smoke.gpu_line()}")


if __name__ == "__main__":
    main()
