"""Build a kernel source with ``nvcc`` into a shared library with a plain C
interface, and load it with ``ctypes``.

Libraries go to ``_build/`` beside this file (ignored by git), named by a
hash of the source and flags, so an edited source rebuilds and an unchanged
one is built once per checkout. A failed build, or a library that does not
load or lacks an entry point, raises :class:`KernelBuildError`.

:func:`load` publishes a library only once ``ctypes`` has loaded it and its
entry points are bound, under one lock, so threads that reach a kernel
together build and load it once. That first build and load is recorded as
a compile under ``kernel.<source stem>`` (:func:`optuna_tpu_torch.flight.
note_kernel_build`). ``utils._compile_cache`` may point :data:`BUILD_DIR`
elsewhere when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) per source.
BUILD_LOGS: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """A kernel's library could not be built or loaded: no ``nvcc``, ``nvcc``
    failed, or the built library does not load or lacks an entry point. A
    device fault, which ``GuardedSampler`` never contains."""


def find_nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise KernelBuildError("nvcc not found: the CUDA kernels of optuna_tpu_torch need the CUDA toolkit.")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built; returns its path."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(source: str, bind: Callable[[ctypes.CDLL], object] | None = None) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``, once per
    process, and declare its entry points with ``bind``. A library that
    ``ctypes`` cannot load (``OSError``), or that lacks an entry point
    ``bind`` declares (``AttributeError``), raises :class:`KernelBuildError`."""
    with _lock:
        lib = _loaded.get(source)
        first = lib is None
        t0 = time.monotonic()
        try:
            if lib is None:
                lib = ctypes.CDLL(str(build(source)))
            if bind is not None:
                bind(lib)
        except (OSError, AttributeError) as err:
            raise KernelBuildError(f"the library of {source} could not be loaded or bound: {err}") from err
        _loaded[source] = lib
    if first:
        from optuna_tpu_torch import flight

        flight.note_kernel_build(Path(source).stem, time.monotonic() - t0)
    return lib
