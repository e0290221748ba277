"""Run the port's tests that need a CUDA card (pytest marker ``cuda``).

Run from anywhere, on a machine with one card:

    python3 scripts/run_cuda_tests.py -q               # every tests/test_torch_*.py
    python3 scripts/run_cuda_tests.py tests/test_torch_wfg.py -x

The tests import their shared helpers as ``tests._torch_port``. ``tests/``
has no ``__init__.py``, so a regular package named ``tests`` installed on
the machine would shadow it; the script binds the name to this checkout's
directory before pytest starts. JAX (the reference, imported by the tests)
stays on the CPU.
"""

from __future__ import annotations

import glob
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    tests = types.ModuleType("tests")
    tests.__path__ = [os.path.join(ROOT, "tests")]
    sys.modules["tests"] = tests
    import pytest

    args = sys.argv[1:]
    # No test path among the arguments (an option's value, as in `-p name`,
    # is not one): every port test file.
    if not any(not a.startswith("-") and os.path.exists(a.split("::")[0]) for a in args):
        args += sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    return pytest.main(["-m", "cuda", "-p", "no:cacheprovider", "-rs", *args])


if __name__ == "__main__":
    sys.exit(main())
