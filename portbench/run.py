#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds fscl_tpu_torch, on a machine with
the NVIDIA cards the cell asks for.  The last line of standard output is
one JSON object (correct, attempted, failed, metrics, device, and with
--trace 1 the breakdown); the numbers the check compared follow as the
last lines of standard error and under "checks".  See harness.py.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, heads the import path: module
# names here never shadow another's
sys.path[0] = str(ROOT)
# caches a CUDA or Triton toolchain may keep stay inside the checkout
CACHE = ROOT / ".portbench_cache"
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
