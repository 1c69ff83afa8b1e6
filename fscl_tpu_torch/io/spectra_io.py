"""Background-spectrum file round trip (a numpy copy of
fscl_tpu/io/spectra_io.py).

Write format (background-fsp.c:318-336): one row per depth,
``depth \t p0 \t p1 ... p_depth`` with %1.6f values.  Load accepts the same
(the reference's loader has an off-by-one count check that rejects its own
output, background-fsp.c:163-167; we accept exactly depth+1 probabilities).
"""

from __future__ import annotations

import numpy as np


def write_spectra(path, sample_depths, fsp_list):
    with open(path, "w") as f:
        for d, fsp in zip(np.asarray(sample_depths).tolist(), fsp_list):
            vals = "\t".join(f"{v:1.6f}" for v in np.asarray(fsp))
            f.write(f"{d}\t{vals}\n")


def load_spectra(path):
    """Returns {depth: np.float64 spectrum of depth+1 bins}."""
    out = {}
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            depth = int(parts[0])
            vals = np.asarray([float(v) for v in parts[1:]], dtype=np.float64)
            if len(vals) != depth + 1:
                raise ValueError(
                    f"line {line_no}: spectrum for depth {depth} should have "
                    f"{depth + 1} classes, found {len(vals)}"
                )
            out[depth] = vals
    return out
