"""portbench's tests run from the repository root or from anywhere: the
root heads the import path, so ``portbench`` and ``fscl_tpu_torch``
import as packages."""

import pathlib
import sys

ROOT = str(pathlib.Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
